"""Dense against blocked-band blurs of the SIFT pyramid, to set the cutoff.

    python3 tools/banded_cutoff.py [--out chiprun_out/banded_cutoff.jsonl]   # on the card
    python3 tools/banded_cutoff.py --device cpu --quick                       # a dry run

Part 1, one blur call alone: an octave's bank (the input and its S+2 = 5
blurs of ``sift_config``'s S=3, as ``SiftPyramid`` calls it) and the base
blur, each built dense and banded (``core.pyramid_ref.BlurBank``), on the
same seeded image at 256, 384, 512, 768, 1024 squared and 376 x 1241, one
frame and eight frames a call: device ms and device ops a call
(``utils.profiling.profile_device``), and the largest difference of the two
forms (banded against dense).

Part 2, end to end under each cutoff (``_BANDED_MIN_SIZE`` = 1, every blur
banded; 256; 512; 1024; or beyond every size, every blur dense):
``SiftPyramid`` alone and the frontend
(``SiftFrontend``, its default branches) at 512^2 / K=512 and 1024^2 /
K=2048, one frame a call and eight frames a call: device ms and device ops
a call; then ``cli bench``'s ``stage_pyramid_ms_512`` (``bench/suite.
bench_stages``, a chained slope) all dense and at cutoffs 512, 256 and 1024
(dense and 512 twice, in turns).

Every line names the card (nvidia-smi's name and power limit). On the CPU
(``--device cpu``) times are host wall ms and ops are not counted: a check
that the script runs, not a measurement.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sift_parallel_optimization_tpu_torch.core import pyramid_ref  # noqa: E402
from sift_parallel_optimization_tpu_torch.models.frontend import (  # noqa: E402
    SiftFrontend,
    sift_config,
)
from sift_parallel_optimization_tpu_torch.utils import native  # noqa: E402

SIZES = ((256, 256), (384, 384), (512, 512), (768, 768), (1024, 1024), (376, 1241))
CUTOFFS = {"dense": 1 << 30, "256": 256, "512": 512, "1024": 1024, "all": 1}
FRONTENDS = ((512, 512), (1024, 2048))
BATCH = 8


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def measure(fn, *args, iters):
    """(device ops, device ms) a call on the card; (None, host wall ms) on
    the CPU."""
    if args[0].is_cuda:
        from sift_parallel_optimization_tpu_torch.utils.profiling import profile_device

        ops, ms, _prof = profile_device(fn, *args, warmup=3, iters=iters)
        return ops, ms
    fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return None, (time.perf_counter() - t0) * 1e3 / iters


def with_cutoff(value: int, build):
    saved = pyramid_ref._BANDED_MIN_SIZE
    pyramid_ref._BANDED_MIN_SIZE = value
    try:
        return build()
    finally:
        pyramid_ref._BANDED_MIN_SIZE = saved


def blur_calls(dev, emit, iters, sizes):
    cfg = sift_config(512)
    rel = pyramid_ref._octave_scale_sigmas(cfg)
    base = [float(np.sqrt(cfg.sigma0 ** 2 - cfg.assumed_blur ** 2))]
    for h, w in sizes:
        img = np.random.default_rng(h * w).random((BATCH, h, w), np.float32)
        for b in (1, BATCH):
            x = torch.from_numpy(img[0] if b == 1 else img).to(dev)
            for name, sigmas, with_input in (("octave bank", rel, True), ("base blur", base, False)):
                forms = {f: with_cutoff(c, lambda: pyramid_ref.BlurBank(
                    h, w, sigmas, with_input, device=dev)) for f, c in
                    (("dense", 1 << 30), ("banded", 1))}
                outs = {f: bank(x) for f, bank in forms.items()}
                err = float((outs["banded"] - outs["dense"]).abs().max())
                rec = {"part": "blur", "call": name, "h": h, "w": w, "frames": b,
                       "max_abs_diff": err}
                for f, bank in forms.items():
                    ops, ms = measure(bank, x, iters=iters)
                    rec[f"{f}_ops"], rec[f"{f}_ms"] = ops, ms
                emit(rec)


def end_to_end(dev, emit, iters, frontends):
    for size, k in frontends:
        frames = torch.stack([torch.from_numpy(native.synth_frame(size, i, seed=0))
                              for i in range(BATCH)]).to(dev)
        for label, cutoff in CUTOFFS.items():
            pyr = with_cutoff(cutoff, lambda: pyramid_ref.SiftPyramid(
                sift_config(size), size, size, device=dev))
            fe = with_cutoff(cutoff, lambda: SiftFrontend(sift_config(size), max_keypoints=k,
                                                          device=dev))
            for b in (1, BATCH):
                x = frames[0] if b == 1 else frames
                rec = {"part": "end_to_end", "size": size, "k": k, "cutoff": label,
                       "forms": pyr.forms, "frames": b}
                rec["pyramid_ops"], rec["pyramid_ms"] = measure(pyr, x, iters=iters)
                rec["frontend_ops"], rec["frontend_ms"] = measure(fe, x, iters=iters)
                emit(rec)


def stage_pyramid(dev, emit):
    from sift_parallel_optimization_tpu_torch.bench import suite

    class Sink:
        def __init__(self):
            self.records = []

        def write(self, metric, value, unit, **extra):
            self.records.append({"metric": metric, "value": value, **extra})

    for label in ("dense", "512", "dense", "512", "256", "1024"):
        sink = Sink()
        t0 = time.perf_counter()
        with_cutoff(CUTOFFS[label], lambda: suite.bench_stages(sink, size=512, device=dev))
        got = {r["metric"]: r["value"] for r in sink.records}
        emit({"part": "stage", "cutoff": label, "stage_pyramid_ms_512": got["stage_pyramid_ms_512"],
              "stage_frontend_ms_512": got["stage_frontend_ms_512"],
              "seconds": time.perf_counter() - t0})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true", help="small sizes, few calls")
    ap.add_argument("--no-stages", action="store_true")
    a = ap.parse_args()
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    who = card()
    out = open(a.out, "w") if a.out else None

    def emit(rec):
        rec = {**rec, "device": who}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    t0 = time.perf_counter()
    if a.quick:
        blur_calls(dev, emit, 2, ((64, 64), (40, 100)))
        end_to_end(dev, emit, 1, ((64, 64),))
    else:
        blur_calls(dev, emit, 20, SIZES)
        end_to_end(dev, emit, 10, FRONTENDS)
        if not a.no_stages:
            stage_pyramid(dev, emit)
    print(f"done in {time.perf_counter() - t0:.1f} s on {who}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
