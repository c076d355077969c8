"""The control: the plain reference computed one precision below the
configuration's (every blur product from TF32-rounded operands), put in
the program's place, must come out not correct.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 [--seconds 3]

runs the cell's harness once a seed with :class:`ControlFrontend` in place
of the program's frontend (a short window at the cell's own load; the
control is slower than the program, so an open loop falls behind) and
prints each run's result line. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import collections
import sys

import torch

from benchmark.reference import sift as reference

Keypoints = collections.namedtuple(
    "Keypoints", ["x", "y", "sigma", "score", "orientation", "octave", "scale", "valid"])
Features = collections.namedtuple("Features", ["keypoints", "descriptors"])


class ControlFrontend:
    """The reference at TF32, called as the program's frontend is: (H, W)
    or (B, H, W) frames on a device -> Features of the program's form."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def _one(self, img: torch.Tensor):
        f = reference.features(img, self.cfg, tf32=True)
        kp = Keypoints(*[f[n] for n in Keypoints._fields])
        return kp, f["desc"]

    def __call__(self, img: torch.Tensor) -> Features:
        if img.dim() == 2:
            return Features(*self._one(img))
        parts = [self._one(frame) for frame in img]
        kp = Keypoints(*[torch.stack([p[0][i] for p in parts]) for i in range(8)])
        return Features(kp, torch.stack([p[1] for p in parts]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from benchmark import run
    from benchmark.spec import Cell

    if not torch.cuda.is_available():
        return run.fail("no CUDA device")
    cell = Cell(args.workload)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        one = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                 trace=0)
        print(f"control seed {seed}", file=sys.stderr)
        rc |= run.run_cell(cell, one, torch.device("cuda", 0),
                           frontend_factory=lambda _fe: ControlFrontend(cell.config))
    return rc


if __name__ == "__main__":
    sys.exit(main())
