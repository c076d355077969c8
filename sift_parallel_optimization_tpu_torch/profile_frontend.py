"""Where the frontend's time goes on the card, stage by stage.

    python -m sift_parallel_optimization_tpu_torch.profile_frontend --size 512 --k 512

Profiles the frontend as it runs on the card by default (block-reduce
detection); ``--exact`` takes the exact detection branch instead and
``--fused`` sets ``models.descriptor.USE_FUSED_SAMPLING``. Warms the
frontend up on ``synth_frame`` frames, then for each stage of
``SiftFrontend`` (gaussian pyramid, detect, describe) prints the median host
milliseconds of a synchronized call with no profiler, and from one
``torch.profiler`` run per stage the number of device kernels and their
summed device time. The device busy share is summed kernel time over
synchronized wall time. ``--out`` writes the kernel table of the whole
frame there. With ``--batch B`` the same table follows for the batched entry
point on B frames, every number divided by B: per-stage wall, device time
and device ops PER FRAME beside the per-frame frontend's. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from sift_parallel_optimization_tpu_torch.models import descriptor
from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
from sift_parallel_optimization_tpu_torch.utils import native
from sift_parallel_optimization_tpu_torch.utils.profiling import profile_device


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile_stages(stages: dict, iters: int, per: int = 1, out: str | None = None) -> None:
    """Print wall, device ops and device time of each stage, divided by
    ``per`` (the frames one call covers)."""
    for name, fn in stages.items():
        wall = statistics.median(_wall_ms(fn) for _ in range(iters)) / per
        n, dev_ms, prof = profile_device(fn, warmup=0, iters=1)
        print(f"  {name:9s} wall {wall:8.3f} ms  device kernels {n / per:7.1f}  "
              f"device {dev_ms / per:7.3f} ms  busy {100 * dev_ms / per / wall:5.1f}%")
        if name == "frame" and out:
            with open(out, "w") as fh:
                fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                                   row_limit=60))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--S", type=int, default=3)
    p.add_argument("--k", type=int, default=512)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--exact", action="store_true", help="exact detection branch")
    p.add_argument("--fused", action="store_true", help="fused descriptor sampling")
    p.add_argument("--out", default=None, help="write the whole-frame kernel table here")
    p.add_argument("--batch", type=int, default=0,
                   help="also profile the batched entry point on this many frames")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frontend needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    descriptor.USE_FUSED_SAMPLING = args.fused
    fe = SiftFrontend(sift_config(args.size, S=args.S), max_keypoints=args.k, device=dev,
                      use_approx_topk=not args.exact)
    img = torch.from_numpy(native.synth_frame(args.size, 0, seed=0)).to(dev)
    for _ in range(3):
        fe(img)
    gauss = fe.gaussian(img)
    kp = fe.detect(gauss)
    stages = {
        "pyramid": lambda: fe.gaussian(img),
        "detect": lambda: fe.detect(gauss),
        "describe": lambda: fe.describe(gauss, kp),
        "frame": lambda: fe(img),
    }
    branch = ("exact" if args.exact else "block-reduce") + (" + fused" if args.fused else "")
    print(f"{torch.cuda.get_device_name(0)} frontend {args.size}^2 S={args.S} K={args.k} "
          f"({branch}), median of {args.iters}:")
    _profile_stages(stages, args.iters, out=args.out)
    if args.batch:
        b = args.batch
        imgs = torch.stack([torch.from_numpy(native.synth_frame(args.size, i, seed=0))
                            for i in range(b)]).to(dev)
        for _ in range(2):
            fe(imgs)
        gauss_b = fe.gaussian(imgs)
        kp_b = fe.detect(gauss_b)
        print(f"batched, B={b}, per frame (each number is the batch's divided by {b}):")
        _profile_stages({
            "pyramid": lambda: fe.gaussian(imgs),
            "detect": lambda: fe.detect(gauss_b),
            "describe": lambda: fe.describe(gauss_b, kp_b),
            "frame": lambda: fe(imgs),
        }, args.iters, per=b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
