"""Kernel 5's design parameters tried on the card, launch by launch.

    python3 tools/kernel5_variants.py [--variants NAME ...] [--out FILE]

Each variant is ``csrc/bf16x3_mm.cu`` with some of its ``constexpr int``
tile parameters (kBM, kBN, kStages) set otherwise, built with the port's
nvcc flags into its own library under ``build/kernel5_variants/`` (all
variants at once, one nvcc each). The launches are those of one "high"
``SiftPyramid`` call on a 512^2 and a 1024^2 frame (``native.synth_frame``,
seed 0), captured once; each variant is held to the plain version at every
launch (``chip_smoke.kernel5_tol``) and timed there (device ms,
``utils.profiling.device_kernel_ms``), the variants in turns, forwards and
then backwards, the two times averaged. Prints one line a variant and one
JSON line with every time, with the card's name and power limit. Needs the
card.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from sift_parallel_optimization_tpu_torch.ops import _build  # noqa: E402

VARIANTS = {
    "64x64 s2": {},
    "64x64 s3": {"kStages": 3},
    "64x64 s4": {"kStages": 4},
    "128x64 s2": {"kBM": 128},
    "64x128 s2": {"kBN": 128},
    "128x64 s3": {"kBM": 128, "kStages": 3},
}
OUT_DIR = HERE / "build" / "kernel5_variants"


def source_of(params: dict) -> str:
    text = (_build.CSRC_DIR / "bf16x3_mm.cu").read_text()
    for name, value in params.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise ValueError(f"no single constexpr {name} in bf16x3_mm.cu")
    return text


def build(names) -> dict:
    """name -> loaded library, every variant compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {}
    for i, name in enumerate(names):
        src = OUT_DIR / f"v{i}.cu"
        src.write_text(source_of(VARIANTS[name]))
        lib = OUT_DIR / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(path))
        _build.bind_bf16x3(lib)
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from sift_parallel_optimization_tpu_torch.core import pyramid_ref as pr
    from sift_parallel_optimization_tpu_torch.models.frontend import sift_config
    from sift_parallel_optimization_tpu_torch.ops import blur_product as bp
    from sift_parallel_optimization_tpu_torch.utils import native
    from sift_parallel_optimization_tpu_torch.utils.profiling import device_kernel_ms

    if not torch.cuda.is_available():
        print("kernel5_variants: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    libs = build(args.variants)
    launches = []
    kernel = bp.bf16x3_bmm_cuda

    def noted(a, b, out=None):
        launches.append((size, a, b, out))
        return kernel(a, b, out=out)

    bp.bf16x3_bmm_cuda = noted
    try:
        for size in (512, 1024):
            img = torch.from_numpy(native.synth_frame(size, 0, seed=0)).to(dev)
            pr.SiftPyramid(sift_config(size, blur_precision="high"), size, device=dev)(img)
    finally:
        bp.bf16x3_bmm_cuda = kernel
    times = {name: [0.0] * len(launches) for name in libs}
    built = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            _build._lib = libs[name]
            built[name] = [bp.kernel_attributes(*kinds) for kinds in bp.PYRAMID_INSTANCES]
            for j, (size, a, b, o) in enumerate(launches):
                got = bp.bf16x3_bmm_cuda(a, b)
                want = bp.bf16x3_bmm_plain(a, b)
                torch.cuda.synchronize()
                cs.check(bool(((got - want).abs() <= cs.kernel5_tol(torch, a, b)).all()),
                         f"{name}: disagrees with plain at {tuple(a.shape)}@{tuple(b.shape)}")
                times[name][j] += device_kernel_ms(bp.bf16x3_bmm_cuda, a, b, o, iters=10) / 2
    _build._lib = None
    for name, ts in times.items():
        by_size = {s: sum(t for t, (sz, *_r) in zip(ts, launches) if sz == s) for s in (512, 1024)}
        print(f"[{name}] {card}: " + ", ".join(
            f"{g['registers']} regs / {g['dynamic_smem']} B / {g['ctas_per_sm']} CTAs"
            for g in built[name]) + "; ms a launch: " + " ".join(f"{t:.4f}" for t in ts)
            + f"; 512^2 sum {by_size[512]:.4f}, 1024^2 sum {by_size[1024]:.4f}", flush=True)
    record = {"card": card, "launches": [[s, list(a.shape), list(b.shape)]
                                         for s, a, b, _o in launches],
              "variants": {n: {"params": VARIANTS[n], "built": built[n], "ms": times[n]}
                           for n in libs}}
    print(json.dumps(record))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
