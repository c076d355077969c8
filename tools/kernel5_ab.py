"""Kernel 5 launch by launch, and the SIFT pyramid at both blur precisions,
for one tree of the repository: to set two trees side by side in one card
call.

    python3 tools/kernel5_ab.py [--root DIR] [--label NAME] [--out FILE]

The port is imported from DIR (default: this checkout), ``chip_smoke.py``'s
``kernel5_launch_times`` from this checkout, so that a parent commit's tree
(``git archive`` into a git-ignored directory) and this one are timed by
the same code. Run parent, change, change, parent in one call and compare
within it. For 512^2 and 1024^2 frames (``native.synth_frame``, seed 0):
each launch of one "high" ``SiftPyramid`` call on one frame (kernel 5,
its plain version and the fp32 product "highest" runs there, device ms,
and its bound), then the pyramid's device ms and ops a call at "highest"
and "high", on 1 and 8 frames. Needs the card; prints one JSON line a size
(written to FILE too) with the card's name and power limit.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SIZES, BATCH = (512, 1024), 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from sift_parallel_optimization_tpu_torch.bench import roofline as R
    from sift_parallel_optimization_tpu_torch.core import pyramid_ref as pr
    from sift_parallel_optimization_tpu_torch.models.frontend import sift_config
    from sift_parallel_optimization_tpu_torch.utils import native

    if not torch.cuda.is_available():
        print("kernel5_ab: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.nvidia_smi()
    peaks = R.device_peaks(dev)
    for size in SIZES:
        frames = torch.stack([torch.from_numpy(native.synth_frame(size, i, seed=0))
                              for i in range(BATCH)]).to(dev)
        rows = cs.kernel5_launch_times(torch, size, frames[0], peaks)
        pyramid = {}
        for prec in ("highest", "high"):
            pyr = pr.SiftPyramid(sift_config(size, blur_precision=prec), size, device=dev)
            for b in (1, BATCH):
                ops, ms = cs.device_profile(torch, pyr, frames[0] if b == 1 else frames, iters=5)
                pyramid[f"{prec} {b}"] = [ms, ops]
        record = {"tree": args.label, "card": card, "size": size, "pyramid_ms_ops": pyramid,
                  "launches": [[list(sa), list(sb), m, p, f, list(bd)]
                               for sa, sb, m, p, f, bd in rows]}
        print(f"[{args.label}] {size}^2 pyramid device ms / ops: " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.0f}" for k, v in pyramid.items())
            + "; " + cs.kernel5_table(size, rows), flush=True)
        print(json.dumps(record), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
