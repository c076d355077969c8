#!/usr/bin/env python3
"""The distributed layer across cards under NCCL: the exchanges between
ranks that one card cannot run (halo strips, the scale split's and the ring
matcher's hops, the CG BA's reduce-scatter and all-gathers, the all-gathers
of the global views), on every (data, spatial) factorization of the world.

    python -m torch.distributed.run --standalone --nproc-per-node 4 tools/mesh_multicard.py \
        --out mesh_w4.jsonl
    python -m torch.distributed.run --standalone --nproc-per-node 4 tools/mesh_multicard.py \
        --device cpu --size 64          # the same on gloo CPU ranks, small

Each sharded entry point runs on every rank; each rank holds the result to
its own unsharded counterpart (bitwise for the REFERENCE splits, 1e-5 for
the SIFT pyramid, slot for slot for the frontend, exactly for the ring
table and the halo, 1e-4 for BA and PGO: the tolerances of
``chip_smoke.py``'s ``mesh`` phase), and the worst rank's gap is what
rank 0 reports: one JSON line an (entry point, mesh), with the sharded and
the unsharded per-call ms (CUDA events on the card, host clock on the CPU)
and the device (nvidia-smi's name and power limit). Exits 1 if any gap is
above its tolerance.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the smoke's scenes and comparisons)

K_NP = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)


def _per_call_ms(torch, fn, dev) -> float:
    from sift_parallel_optimization_tpu_torch.utils.profiling import cuda_time_ms

    if dev.type == "cuda":
        return cuda_time_ms(fn, warmup=1, iters=3)
    fn()
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def _inputs(torch, dev, size: int) -> dict:
    """The arguments of ``chip_smoke.mesh_calls``: synthetic frames, random
    keyframes, the BA arc and the pgo phase's graph."""
    from sift_parallel_optimization_tpu_torch.utils import native

    frames = torch.stack([torch.from_numpy(native.synth_frame(size, i, seed=0))
                          for i in range(cs.BATCH)]).to(dev)
    img = frames[0]
    big = torch.nn.functional.interpolate(img[None, None], size=(2 * size, 2 * size))[0, 0]
    rng = np.random.default_rng(0)
    desc = rng.normal(size=(50, 512, 128)).astype(np.float32)
    desc[1:, :200] = desc[:-1, :200] + 0.01 * rng.normal(size=(49, 200, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = rng.random((50, 512)) < 0.9
    return dict(img=img, sift_imgs=[img, big], batch=frames,
                keyframes=(torch.from_numpy(desc).to(dev), torch.from_numpy(valid).to(dev)),
                arc=cs.ba_arc(torch, dev, K_NP), graph=cs.pgo_graph(torch, dev))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (NCCL, a card a rank) or cpu (gloo)")
    p.add_argument("--size", type=int, default=512, help="frame side (the SIFT pyramid also 2x)")
    p.add_argument("--out", default=None, help="JSONL file rank 0 writes (default: stdout only)")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from sift_parallel_optimization_tpu_torch.bench.suite import device_label
    from sift_parallel_optimization_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    dev = initialize_distributed(device=args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    label = device_label(dev)
    records = []
    for n_data in [d for d in (1, 2, 4, 8) if world % d == 0]:
        mesh = make_mesh(n_data, world // n_data)
        calls = cs.mesh_calls(torch, dev, mesh, **_inputs(torch, dev, args.size))
        for name, (sharded, unsharded, gap, tol) in calls.items():
            err = torch.tensor([gap(sharded(), unsharded())], dtype=torch.float64, device=dev)
            dist.all_reduce(err, op=dist.ReduceOp.MAX)          # the worst rank's gap
            rec = {"world": world, "mesh": f"{n_data}x{world // n_data}", "entry": name,
                   "max_gap": float(err), "tol": tol, "ok": float(err) <= tol,
                   "ms": round(_per_call_ms(torch, sharded, dev), 4),
                   "unsharded_ms": round(_per_call_ms(torch, unsharded, dev), 4),
                   "device": label, "backend": dist.get_backend()}
            records.append(rec)
            if rank == 0:
                print(json.dumps(rec), flush=True)
    if rank == 0 and args.out:
        with open(args.out, "a") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in records)
    dist.destroy_process_group()
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
