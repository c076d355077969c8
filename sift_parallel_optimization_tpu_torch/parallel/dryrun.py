"""Multi-rank dry run of the sharded scale space (the port's counterpart of
the JAX package's ``dryrun_multichip`` in ``__graft_entry__.py``).

    python -m sift_parallel_optimization_tpu_torch.parallel.dryrun --device cpu
    torchrun --nproc-per-node 4 -m sift_parallel_optimization_tpu_torch.parallel.dryrun

Each rank runs one step of the REFERENCE row-sharded pyramid and one of the
SIFT row-sharded pyramid (halo exchange) on a small (data, spatial) mesh, and
one data-parallel step of the batched REFERENCE pyramid over a frame batch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of each sharded path over a mesh of ``n_devices`` ranks (the
    default process group's world size; at 1 it forms the group in this
    process). The spatial axis takes 4, 2 or 1 of them, as the JAX dry run
    lays it out. Returns the octaves' sums of each path (every rank gets
    the same)."""
    import torch.distributed as dist

    from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
    from sift_parallel_optimization_tpu_torch.core.pyramid_ref import reference_dog_pyramid
    from sift_parallel_optimization_tpu_torch.parallel.mesh import (
        axis_index,
        initialize_distributed,
        make_mesh,
    )
    from sift_parallel_optimization_tpu_torch.parallel.scale_space import (
        sharded_reference_dog_pyramid,
        sharded_sift_gaussian_pyramid,
    )

    dev = initialize_distributed(device=device)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun over {n_devices} ranks in a world of {dist.get_world_size()}")
    n_spatial = next(c for c in (4, 2, 1) if n_devices % c == 0)
    mesh = make_mesh(n_data=n_devices // n_spatial, n_spatial=n_spatial)
    size = max(64, 8 * 2 * n_spatial)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((size, size), np.float32)).to(dev)

    # REFERENCE mode, rows sharded over `spatial`.
    ref = [float(o.full_tensor().sum()) for o in sharded_reference_dog_pyramid(img, 2, mesh,
                                                                              n_octaves=2)]
    # SIFT mode: true separable convolution with the halo exchange.
    cfg = PyramidConfig(length=size, S=2, mode=ScaleSpaceMode.SIFT, max_octaves=2)
    sift = [float(o.full_tensor().sum()) for o in sharded_sift_gaussian_pyramid(img, cfg, mesh)]
    # Data parallel over a batch of frames: each rank its two frames.
    n_data = n_devices // n_spatial
    batch = torch.from_numpy(rng.random((n_data * 2, size, size), np.float32)).to(dev)
    mine = batch[axis_index(mesh, "data") * 2:][:2]
    dp = [float(sum(o.sum() for o in reference_dog_pyramid(f, 2, n_octaves=3))) for f in mine]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"mesh": f"{n_devices // n_spatial}x{n_spatial}", "reference": ref, "sift": sift,
            "data_parallel": dp}


def main(argv=None) -> int:
    import torch.distributed as dist

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (NCCL, default) or cpu (gloo)")
    args = p.parse_args(argv)
    out = dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")), device=args.device)
    if dist.get_rank() == 0:
        print(out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
