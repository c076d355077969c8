"""Mesh-size scaling sweep (port of ``bench/scaling.py``): the reference's
Timing_ThreadCount (a THREAD_COUNT = 1..7 sweep printing seconds a pass,
GaussDePyramid-pThread.h:310-326), with the mesh as the knob.

* The data-parallel frontend: a batch of frames split over the ``data`` axis
  of n ranks, each rank one OS process (``python -m
  sift_parallel_optimization_tpu_torch.bench.scaling --child ...``) that
  runs the batched frontend on its shard (``parallel/frontend.local_frames``,
  the split of ``batched_extract_features(mesh=)``), its matrices held
  across the timed batches. On the card each
  rank takes one card under NCCL, so only rank counts up to
  ``torch.cuda.device_count()`` run; on the CPU the ranks are gloo
  processes. A record is the best of a few synchronized batches on the
  host clock, the slowest rank's, over the batch: ms a frame, and the
  efficiency against the smallest count (t_min / (n / n_min * t_n)).
* The row-sharded SIFT pyramid: the analytic link bytes a frame of
  ``bench/roofline.py`` at each count, and the strong-scaling efficiency
  they project against the card's own 512^2 SIFT pyramid time, measured in
  this run (the JAX module used a TPU time from BASELINE.md). The
  projection assumes no overlap; the overlap-aware one needs a measured
  exchange latency, which one card cannot give, and stays None.

Every record carries the suite's ``device`` and ``backend`` (the device
type) and ``dist_backend`` (nccl or gloo); the frontend records
``mesh_devices`` and the pyramid records ``single_chip_ms`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sift_parallel_optimization_tpu_torch.utils.profiling import MetricsWriter

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHILD_TIMEOUT_S = 600


def _child(args) -> int:
    """One rank: the batched frontend on its shard of the frames, timed."""
    import torch.distributed as dist

    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
    from sift_parallel_optimization_tpu_torch.parallel.frontend import local_frames
    from sift_parallel_optimization_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = initialize_distributed(num_processes=args.world, process_id=args.rank,
                                 store=dist.FileStore(args.store, args.world),
                                 device=args.device, timeout_s=CHILD_TIMEOUT_S)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    mesh = make_mesh(n_data=args.world, n_spatial=1)
    cfg = sift_config(args.size, max_octaves=4)
    frames = torch.from_numpy(np.random.default_rng(0).random(
        (args.batch, args.size, args.size), np.float32)).to(dev)
    local = local_frames(frames, mesh)
    fe = SiftFrontend(cfg, args.size, args.size, max_keypoints=128, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fe(local)                                          # warm-up
    best = float("inf")
    for _ in range(args.repeats):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        out = fe(local)
        float(out.descriptors.sum())
        sync()
        ms = torch.tensor([(time.perf_counter() - t0) * 1e3], device=dev)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)      # the slowest rank sets the batch
        best = min(best, float(ms))
    if dist.get_rank() == 0:
        print(json.dumps({"n": args.world, "total_ms": best, "dist_backend": dist.get_backend()}))
    dist.destroy_process_group()
    return 0


def _run_ranks(n: int, size: int, batch: int, device: str, repeats: int) -> tuple[dict | None, str]:
    """Start n ranks and wait for them: (rank 0's record or None, stderr)."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        env = dict(os.environ, PYTHONPATH=_REPO)
        cmd = [sys.executable, "-m", "sift_parallel_optimization_tpu_torch.bench.scaling",
               "--child", "--world", str(n), "--store", store, "--size", str(size),
               "--batch", str(batch), "--device", device, "--repeats", str(repeats)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=_REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(n)]
        outs, t0 = [], time.monotonic()
        try:
            for p in procs:
                left = max(1.0, CHILD_TIMEOUT_S - (time.monotonic() - t0))
                outs.append(p.communicate(timeout=left))
        except subprocess.TimeoutExpired:
            outs = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    if outs is None:
        return None, f"ranks still running after {CHILD_TIMEOUT_S} s"
    err = "".join(e for _o, e in outs)
    if any(p.returncode for p in procs):
        return None, err
    try:
        return json.loads(outs[0][0].strip().splitlines()[-1]), err
    except (IndexError, json.JSONDecodeError):
        return None, err


def bench_scaling(
    writer: MetricsWriter,
    size: int = 256,
    batch: int = 8,
    device_counts=(1, 2, 4, 8),
    device="cuda",
    repeats: int = 5,
    **kw,
) -> None:
    """DP frontend ms a frame against the rank count (batch fixed), and the
    sharded pyramid's link bytes and projected efficiency (module
    docstring). A rank group that fails writes its record with value -1
    and the end of its errors, as the JAX module does."""
    from sift_parallel_optimization_tpu_torch.bench import roofline as R
    from sift_parallel_optimization_tpu_torch.bench.suite import _Records
    from sift_parallel_optimization_tpu_torch.core.pyramid_ref import SiftPyramid
    from sift_parallel_optimization_tpu_torch.models.frontend import sift_config
    from sift_parallel_optimization_tpu_torch.parallel.mesh import backend_for

    rec = _Records(writer, device)
    dist_backend = backend_for(rec.dev)
    counts = [n for n in device_counts
              if rec.dev.type != "cuda" or n <= torch.cuda.device_count()]
    results: dict[int, float] = {}
    for n in counts:
        out, err = _run_ranks(n, size, batch, rec.dev.type, repeats)
        name = f"scaling_frontend_{size}_n{n}"
        if out is None:
            rec.write(name, -1.0, "ms", error=err[-300:], dist_backend=dist_backend)
            continue
        results[n] = out["total_ms"]
        n0 = min(results)
        eff = results[n0] / (n / n0 * out["total_ms"])
        rec.write(name, round(out["total_ms"] / batch, 3), "ms/frame", mesh_devices=n,
                  batch=batch, efficiency_vs_smallest=round(eff, 3),
                  ici_bytes_per_step=R.dp_frontend_ici_bytes(),
                  dist_backend=out["dist_backend"])

    # The row-sharded SIFT pyramid: link bytes a frame and device at each
    # count, projected against this device's own 512^2 pyramid time.
    cfg = sift_config(512)
    pyr = SiftPyramid(cfg, 512, device=rec.dev)
    img = torch.from_numpy(np.random.default_rng(0).random((512, 512), np.float32)).to(rec.dev)
    single_ms, _chain = rec.slope(lambda x: sum(o.sum() for o in pyr(x)), img, chain_lo=5,
                                  chain_hi=40)
    for n in device_counts:
        bytes_dev = R.sharded_pyramid_ici_bytes(cfg, n)
        dep, n_ex = R.sharded_pyramid_overlap_model(cfg, n)
        no_overlap = (None if rec.peaks is None
                      else R.projected_efficiency(single_ms, n, bytes_dev, rec.peaks))
        rec.write(f"scaling_pyramid_ici_bytes_512_n{n}", bytes_dev, "bytes/frame/device",
                  mesh_devices=n, projected_eff_no_overlap=no_overlap,
                  projected_eff_overlap=None, dep_fraction=round(dep, 4), n_exchanges=n_ex,
                  single_chip_ms=round(single_ms, 4), dist_backend=dist_backend)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of bench_scaling's frontend sweep")
    p.add_argument("--child", action="store_true", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--repeats", type=int, default=5)
    return _child(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
