#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sift_parallel_optimization_tpu_torch/
csrc``, checks each against its plain PyTorch version on the card, drives
the entry points (the REFERENCE DoG pyramid at 512^2, S=2; the SIFT
frontend at 512^2/K=512 and 1024^2/K=2048, S=3, on its default block-reduce
detection branch; and the frontend with fused descriptor sampling at
512^2/K=512) and checks their outputs against the port's plain run on CPU
tensors. Each phase prints one line; then a JSON line of the kernels, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``. Any
failure exits nonzero without that line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC_K1 = "sift_parallel_optimization_tpu_torch/csrc/reference_dog.cu"
SRC_K2 = "sift_parallel_optimization_tpu_torch/csrc/patch_gather.cu"
SRC_K3 = "sift_parallel_optimization_tpu_torch/csrc/score_tables.cu"
SRC_K4 = "sift_parallel_optimization_tpu_torch/csrc/gather_resample.cu"
# file:line of the TPU kernels each CUDA kernel replaces.
REPLACES_K1 = "sift_parallel_optimization_tpu/ops/scale_space_pallas.py:86"
REPLACES_K2 = "sift_parallel_optimization_tpu/ops/patch_gather.py:66"
REPLACES_K3 = "sift_parallel_optimization_tpu/ops/detect_fused.py:209"
REPLACES_K4 = "sift_parallel_optimization_tpu/ops/descriptor_fused.py:138"

# Kernel 1 vs its plain version: the tolerance of the JAX package's Pallas
# equivalence test (tests/test_scale_space_pallas.py).
K1_RTOL, K1_ATOL = 1e-5, 1e-6
# Headline vs the plain run on CPU tensors: exp of the window bank may
# differ by an ulp between the CPU and CUDA math libraries.
HEADLINE_ATOL = 1e-5
# Frontend, frame 0, card vs CPU: the two sum the blur products in another
# order, which can flip a candidate at a threshold; so >= 99% of CPU
# keypoints must be matched (same octave and scale, within 0.05 px) and
# >= 99% of matched descriptors must lie within L2 0.02.
MATCH_PX, MATCH_FRAC, DESC_L2, DESC_FRAC = 0.05, 0.99, 0.02, 0.99
# Kernel 4 vs its plain version (batched matmuls that may sum with FMAs).
K4_RTOL, K4_ATOL = 1e-5, 1e-6
# Keypoints of the block-reduce branch found by the exact one, frame 0.
RECALL_MIN = 0.95
FRAMES = 8
FRONTEND_CONFIGS = ((512, 3, 512), (1024, 3, 2048))
FUSED_CONFIG = (512, 3, 512)
# The kernels each path of the main path must launch.
PATH_KERNELS = {
    "headline": ("reference_dog_pyramid",),
    512: ("patch_gather", "score_tables"),
    1024: ("patch_gather", "score_tables"),
    "fused": ("score_tables", "gather_resample"),
}
THR = 0.04 / 3          # detect.CONTRAST_THRESHOLD / S
EDGE_RATIO = 10.0


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def keyset(kp) -> set:
    v = kp.valid.cpu()
    return set(zip(*(f.cpu()[v].mul(1000).round().tolist() for f in (kp.x, kp.y, kp.sigma))))


def max_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def kernel1_checks(torch, ss, dev):
    """Kernel vs plain on the card at 512^2, 1024^2 and a ragged 1000^2."""
    import numpy as np

    errs = []
    for n in (512, 1024, 1000):
        img = torch.from_numpy(
            np.random.default_rng(n).random((n, n), dtype=np.float32)
        ).to(dev)
        got = ss.reference_dog_pyramid_cuda(img, 2)
        want = ss.reference_dog_pyramid_plain(img, 2)
        torch.cuda.synchronize()
        check(len(got) == len(want), f"kernel 1: octave count at {n}")
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"kernel 1: shape {tuple(g.shape)} at {n}")
            check(bool(torch.allclose(g, w, rtol=K1_RTOL, atol=K1_ATOL)),
                  f"kernel 1 disagrees with plain at {n}: {max_err(got, want)}")
        errs.append(max_err(got, want))
    return max(errs)


def frontend_atlas(torch, dev, size, S):
    """The descriptor atlas the frontend builds for a size^2 frame."""
    from sift_parallel_optimization_tpu_torch.models import descriptor, frontend
    from sift_parallel_optimization_tpu_torch.utils import native

    fe = frontend.SiftFrontend(frontend.sift_config(size, S=S), device=dev)
    img = torch.from_numpy(native.synth_frame(size, 0, seed=0)).to(dev)
    atlas, _meta = descriptor.build_atlas(fe.pyramid(img))
    return atlas


def gather_origins(torch, rng, k, r, c, rows, cols, dev):
    ys = rng.integers(0, (r - rows) // 8 + 1, size=k).astype("int32") * 8
    xs = rng.integers(0, (c - cols) // 128 + 1, size=k).astype("int32") * 128
    ys[0], xs[0] = r - rows, c - cols          # last legal row and column
    ys[1], xs[1] = r - rows, 0
    return (torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev))


def frontend_dogs(torch, dev, size, S):
    """The DoG octaves the frontend detects on for frame 0 of a size^2 stream."""
    from sift_parallel_optimization_tpu_torch.models import frontend
    from sift_parallel_optimization_tpu_torch.utils import native

    fe = frontend.SiftFrontend(frontend.sift_config(size, S=S), device=dev)
    img = torch.from_numpy(native.synth_frame(size, 0, seed=0)).to(dev)
    return [g[1:] - g[:-1] for g in fe.pyramid(img)]


def kernel3_checks(torch, st, dev):
    """Both entry points vs their plain versions, bitwise, on random DoG
    stacks and on the frontend's own octaves. Returns (cases, max abs
    error, stacks)."""
    import numpy as np

    stacks = {f"random {s[1]}x{s[2]}": [torch.from_numpy(
        (0.05 * np.random.default_rng(s[1]).normal(size=s)).astype(np.float32)).to(dev)]
        for s in ((5, 512, 512), (5, 1024, 1024), (5, 250, 370))}
    for size in (512, 1024):
        stacks[f"frontend {size}^2 octaves"] = frontend_dogs(torch, dev, size, 3)
    cases, err = 0, 0.0
    for name, dogs in stacks.items():
        for dog in dogs:
            got = st.score_tables_rows_cuda(dog.contiguous(), THR, EDGE_RATIO)
            want = st.score_tables_rows_plain(dog, THR, EDGE_RATIO)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"kernel 3 rows not bitwise equal to plain on {name} {tuple(dog.shape)}")
            err = max(err, max_err(got, want))
            cases += 1
        flat = torch.cat([d.reshape(-1) for d in dogs])
        shapes = [tuple(d.shape) for d in dogs]
        for refine in (0, 1):
            got = st.score_block_top2_cuda(flat, shapes, THR, EDGE_RATIO, refine)
            want = st.score_block_top2_plain(flat, shapes, THR, EDGE_RATIO, refine)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"kernel 3 block top-2 not bitwise equal to plain on {name}, refine {refine}")
            err = max(err, max_err(got, want))
            cases += 1
    return cases, err, stacks


def kernel4_inputs(torch, rng, k, atlas, dev):
    """In-range keypoints as the fused branch forms them: origins aligned to
    8 rows and 128 columns, centres and radii inside the 128 x 256 patch."""
    r, c = atlas.shape
    grow = rng.integers(0, (r - 128) // 8 + 1, size=k).astype("int32") * 8
    x0 = rng.integers(0, (c - 256) // 128 + 1, size=k).astype("int32") * 128
    grow[0], x0[0] = r - 128, c - 256
    params = np.stack([rng.uniform(56, 72, k), rng.uniform(136, 156, k),
                       rng.uniform(2, 17, k), rng.uniform(4, 51, k)], 1).astype("float32")
    return (atlas, torch.from_numpy(grow).to(dev), torch.from_numpy(x0).to(dev),
            torch.from_numpy(params).to(dev))


def device_profile(torch, fn, *args, iters=10):
    """(device activities, device ms) per call from one profiler run."""
    from torch.profiler import ProfilerActivity, profile

    from sift_parallel_optimization_tpu_torch.utils.profiling import device_activity

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    n, ms = device_activity(prof)
    return n / iters, ms / iters


def frame_ms(torch, fe, frames):
    """Median and max host ms of a synchronized frame over two passes."""
    samples = []
    for _ in range(2):
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fe(f)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples)), max(samples), len(samples)


def counted(torch, counters, fn):
    """Run one path with every launch counter set to 0 just before it;
    returns (its output, each kernel's launches during it)."""
    for mod in counters.values():
        mod.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: mod.LAUNCHES for name, mod in counters.items()}


def drive_main_path(torch, dev, frames, counters):
    """The port's entry points, as a user calls them, each path counted on
    its own: the headline pyramid, the frontend (default branches) at both
    sizes, and the frontend with fused descriptor sampling. Returns (pyramid,
    features, per-path launch counts)."""
    from sift_parallel_optimization_tpu_torch.core.pyramid_ref import reference_dog_pyramid
    from sift_parallel_optimization_tpu_torch.models import descriptor
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config

    launches = {}
    pyr, launches["headline"] = counted(
        torch, counters, lambda: reference_dog_pyramid(frames["headline"], 2))
    feats = {}
    for size, S, k in FRONTEND_CONFIGS:
        fe = SiftFrontend(sift_config(size, S=S), max_keypoints=k, device=dev)
        out, launches[size] = counted(torch, counters, lambda: [fe(f) for f in frames[size]])
        feats[size] = (fe, out)
    size, S, k = FUSED_CONFIG
    fe = SiftFrontend(sift_config(size, S=S), max_keypoints=k, device=dev)
    descriptor.USE_FUSED_SAMPLING = True
    try:
        out, launches["fused"] = counted(torch, counters, lambda: [fe(f) for f in frames[size]])
        feats["fused"] = (fe, out)
    finally:
        descriptor.USE_FUSED_SAMPLING = False
    return pyr, feats, launches


def check_features(torch, feats, size, k):
    for i, f in enumerate(feats):
        kp, desc = f.keypoints, f.descriptors
        check(desc.shape == (k, 128) and kp.capacity == k, f"frontend {size}: shapes")
        check(bool(torch.isfinite(desc).all()), f"frontend {size} frame {i}: nonfinite")
        n = int(kp.count())
        check(n > 0, f"frontend {size} frame {i}: no keypoints")
        norms = torch.linalg.vector_norm(desc, dim=1)
        check(bool(((norms[kp.valid] - 1).abs() < 1e-3).all()),
              f"frontend {size} frame {i}: descriptors not unit norm")
        check(bool((desc[~kp.valid] == 0).all()),
              f"frontend {size} frame {i}: invalid slots not zero")


def compare_with_cpu(torch, gpu, cpu, size):
    """Fraction of CPU keypoints matched on the card and fraction of matched
    descriptors within DESC_L2."""
    g, c = gpu.keypoints, cpu.keypoints
    gv, cv = g.valid.cpu(), c.valid
    gx, gy = g.x.cpu()[gv], g.y.cpu()[gv]
    go, gs = g.octave.cpu()[gv], g.scale.cpu()[gv]
    gd = gpu.descriptors.cpu()[gv]
    cx, cy, co, cs = c.x[cv], c.y[cv], c.octave[cv], c.scale[cv]
    cd = cpu.descriptors[cv]
    check(len(cx) > 0 and len(gx) > 0, f"frontend {size}: no keypoints to compare")
    dist = torch.maximum((cx[:, None] - gx[None]).abs(), (cy[:, None] - gy[None]).abs())
    same = (co[:, None] == go[None]) & (cs[:, None] == gs[None])
    best, j = torch.where(same, dist, torch.full_like(dist, float("inf"))).min(dim=1)
    matched = best <= MATCH_PX
    frac = float(matched.float().mean())
    l2 = torch.linalg.vector_norm(cd[matched] - gd[j[matched]], dim=1)
    dfrac = float((l2 <= DESC_L2).float().mean()) if len(l2) else 0.0
    return frac, dfrac, int(cv.sum()), int(gv.sum())


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from sift_parallel_optimization_tpu_torch.core import pyramid_ref
        from sift_parallel_optimization_tpu_torch.models import descriptor
        from sift_parallel_optimization_tpu_torch.models.frontend import (
            SiftFrontend,
            sift_config,
        )
        from sift_parallel_optimization_tpu_torch.ops import _build
        from sift_parallel_optimization_tpu_torch.ops import gather_resample as gr
        from sift_parallel_optimization_tpu_torch.ops import patch_gather as pg
        from sift_parallel_optimization_tpu_torch.ops import scale_space as ss
        from sift_parallel_optimization_tpu_torch.ops import score_tables as st
        from sift_parallel_optimization_tpu_torch.utils import native
        from sift_parallel_optimization_tpu_torch.utils.profiling import (
            cuda_time_ms,
            device_kernel_ms,
        )
    except ImportError as e:
        print(f"FAIL: the port is not importable from {HERE}: {e}", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()

    # 1. Device.
    phase("device", f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} nvidia-smi='{smi}' "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. Build every kernel from the checkout's sources.
    t0 = time.perf_counter()
    nvcc_s = _build.build(force=True)
    _build.load_kernels()
    phase("build", f"nvcc {nvcc_s:.2f} s, build+load {time.perf_counter() - t0:.2f} s "
          f"-> {os.path.relpath(_build.LIB_PATH, HERE)}")

    # 3. Kernel 1 vs its plain version on the card.
    k1_err = kernel1_checks(torch, ss, dev)
    img512 = torch.from_numpy(native.synth_frame(512, 0, seed=0)).to(dev)
    # Device time of the launched kernels (profiler), and per-call time
    # between CUDA events, which includes the host's enqueue time.
    k1_ms = device_kernel_ms(ss.reference_dog_pyramid_cuda, img512, 2, iters=50)
    k1_plain_ms = device_kernel_ms(ss.reference_dog_pyramid_plain, img512, 2, iters=50)
    k1_call = cuda_time_ms(ss.reference_dog_pyramid_cuda, img512, 2, iters=50)
    k1_plain_call = cuda_time_ms(ss.reference_dog_pyramid_plain, img512, 2, iters=50)
    phase("kernel1", f"reference_dog_pyramid at 512/1024/1000^2 S=2: max_abs_err={k1_err:.3e} "
          f"(rtol {K1_RTOL}, atol {K1_ATOL}); 512^2 device: kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms; per call: kernel {k1_call:.4f} ms, "
          f"plain {k1_plain_call:.4f} ms")

    # 4. Kernel 2 vs its plain version on the card, on the frontend's atlases.
    rng = np.random.default_rng(0)
    rows, cols = 96, 256
    k2_ms, k2_err = {}, 0.0
    for size, k in ((512, 512), (1024, 2048)):
        atlas = frontend_atlas(torch, dev, size, 3)
        ys, xs = gather_origins(torch, rng, k, atlas.shape[0], atlas.shape[1], rows, cols, dev)
        got = pg.extract_atlas_patches_cuda(atlas, ys, xs, rows, cols)
        want = pg.extract_atlas_patches_plain(atlas, ys, xs, rows, cols)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"kernel 2 not bitwise equal at K={k}")
        k2_err = max(k2_err, float((got - want).abs().max()))
        args = (atlas, ys, xs, rows, cols)
        k2_ms[k] = (
            device_kernel_ms(pg.extract_atlas_patches_cuda, *args, iters=50),
            device_kernel_ms(pg.extract_atlas_patches_plain, *args, iters=50),
            cuda_time_ms(pg.extract_atlas_patches_cuda, *args, iters=50),
            cuda_time_ms(pg.extract_atlas_patches_plain, *args, iters=50),
            tuple(atlas.shape),
        )
    phase("kernel2", "patch_gather 96x256 bitwise equal; " + "; ".join(
        f"K={k} atlas {a}: device kernel {m:.4f} ms, plain {p:.4f} ms; per call kernel "
        f"{mc:.4f} ms, plain {pc:.4f} ms" for k, (m, p, mc, pc, a) in k2_ms.items()))

    # 4b. Kernel 3, both entry points, vs the plain versions on the card.
    k3_cases, k3_err, stacks = kernel3_checks(torch, st, dev)
    k3_ms = {}
    for name in ("random 512x512", "random 1024x1024"):
        dog = stacks[name][0]
        k3_ms[f"rows {name}"] = tuple(
            f(g, dog, THR, EDGE_RATIO, iters=50)
            for f in (device_kernel_ms, cuda_time_ms)
            for g in (st.score_tables_rows_cuda, st.score_tables_rows_plain))
    for size in (512, 1024):
        dogs = stacks[f"frontend {size}^2 octaves"]
        args = (torch.cat([d.reshape(-1) for d in dogs]), [tuple(d.shape) for d in dogs],
                THR, EDGE_RATIO, 1)
        k3_ms[f"block_top2 {size}^2 pyramid"] = tuple(
            f(g, *args, iters=50)
            for f in (device_kernel_ms, cuda_time_ms)
            for g in (st.score_block_top2_cuda, st.score_block_top2_plain))
    phase("kernel3", f"score_tables rows + block_top2 bitwise equal to plain in {k3_cases} "
          f"cases, max_abs_err={k3_err:.3e} "
          f"(random 512^2, 1024^2, 250x370 stacks; frontend 512^2, 1024^2 octaves); " +
          "; ".join(f"{n}: device kernel {m:.4f} ms, plain {p:.4f} ms; per call kernel "
                    f"{mc:.4f} ms, plain {pc:.4f} ms" for n, (m, p, mc, pc) in k3_ms.items()))

    # 4c. Kernel 4 vs its plain version on the card, on the frontend's atlases.
    k4_ms, k4_err = {}, 0.0
    for size, k in ((512, 512), (1024, 2048)):
        args = kernel4_inputs(torch, rng, k, frontend_atlas(torch, dev, size, 3), dev)
        got = gr.gather_resample_cuda(*args)
        want = gr.gather_resample_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(bool(torch.allclose(g, w, rtol=K4_RTOL, atol=K4_ATOL)),
                  f"kernel 4 disagrees with plain at K={k}: {max_err(got, want)}")
        k4_err = max(k4_err, max_err(got, want))
        k4_ms[k] = (
            device_kernel_ms(gr.gather_resample_cuda, *args, iters=50),
            device_kernel_ms(gr.gather_resample_plain, *args, iters=50),
            cuda_time_ms(gr.gather_resample_cuda, *args, iters=50),
            cuda_time_ms(gr.gather_resample_plain, *args, iters=50),
            tuple(args[0].shape),
        )
    phase("kernel4", f"gather_resample 18^2 + 26^2 grids: max_abs_err={k4_err:.3e} (rtol "
          f"{K4_RTOL}, atol {K4_ATOL}); " + "; ".join(
              f"K={k} atlas {a}: device kernel {m:.4f} ms, plain {p:.4f} ms; per call kernel "
              f"{mc:.4f} ms, plain {pc:.4f} ms" for k, (m, p, mc, pc, a) in k4_ms.items()))

    # Inputs of the main path, on the card before the run.
    frames = {"headline": img512}
    for size, _S, _k in FRONTEND_CONFIGS:
        frames[size] = [
            torch.from_numpy(native.synth_frame(size, i, seed=0)).to(dev) for i in range(FRAMES)
        ]
    # Counters from the main path's runs alone, one path at a time.
    counters = {"reference_dog_pyramid": ss, "patch_gather": pg, "score_tables": st,
                "gather_resample": gr}
    pyr, feats, path_launches = drive_main_path(torch, dev, frames, counters)

    # 5. Headline: the kernel path vs the plain version on CPU tensors.
    want = pyramid_ref.reference_dog_pyramid(img512.cpu(), 2)
    check(len(pyr) == len(want), "headline: octave count")
    for g, w in zip(pyr, want):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()), "headline: shape/finite")
        check(bool(torch.allclose(g.cpu(), w, rtol=0, atol=HEADLINE_ATOL)),
              f"headline disagrees with the CPU plain run: {max_err([g.cpu()], [w])}")
    head_err = max(float((g.cpu() - w).abs().max()) for g, w in zip(pyr, want))
    head_ms = cuda_time_ms(pyramid_ref.reference_dog_pyramid, img512, 2, iters=50)
    head_plain_ms = cuda_time_ms(ss.reference_dog_pyramid_plain, img512, 2, iters=50)
    head_dev = device_kernel_ms(pyramid_ref.reference_dog_pyramid, img512, 2, iters=50)
    phase("headline", f"pyramid+DoG 512^2 S=2 synth_frame: {len(pyr)} octaves, vs CPU plain "
          f"max_abs_err={head_err:.3e} (atol {HEADLINE_ATOL}); kernel path {head_ms:.4f} "
          f"ms/frame (device {head_dev:.4f} ms), plain torch on card {head_plain_ms:.4f} ms/frame")

    # 6. Frontend at both configs (block-reduce detection, the card's
    # default) and with fused sampling: sanity on every frame, parity of
    # frame 0 with the same branches run on CPU tensors.
    timings = {}
    for name, (size, S, k) in [(c[0], c) for c in FRONTEND_CONFIGS] + [("fused", FUSED_CONFIG)]:
        fe, out = feats[name]
        check_features(torch, out, size, k)
        cpu_fe = SiftFrontend(sift_config(size, S=S), max_keypoints=k, use_approx_topk=True)
        descriptor.USE_FUSED_SAMPLING = name == "fused"
        try:
            cpu = cpu_fe(frames[size][0].cpu())
            frac, dfrac, n_cpu, n_gpu = compare_with_cpu(torch, out[0], cpu, size)
            check(frac >= MATCH_FRAC, f"frontend {name}: only {frac:.4f} of CPU keypoints matched")
            check(dfrac >= DESC_FRAC, f"frontend {name}: only {dfrac:.4f} of descriptors within L2")
            timings[name] = frame_ms(torch, fe, frames[size]) + device_profile(torch, fe, frames[size][0])
        finally:
            descriptor.USE_FUSED_SAMPLING = False
        ms, mx, n, nk, dms = timings[name]
        counts = [int(o.keypoints.count()) for o in out]
        phase("frontend", f"{name if name == 'fused' else 'block-reduce'} {size}^2 S={S} K={k}: "
              f"median {ms:.3f} ms/frame, max {mx:.3f} (n={n}, host clock, synchronized), "
              f"device {dms:.3f} ms in {nk:.0f} device ops/frame; keypoints/frame "
              f"{min(counts)}..{max(counts)}; frame 0 vs CPU: {n_gpu} vs {n_cpu} keypoints, "
              f"matched {frac:.4f}, descriptors within L2 {DESC_L2}: {dfrac:.4f}")

    # 7. The exact branch on the card: recall of the block-reduce branch
    # against it on frame 0, and its frame time in this same call.
    for size, S, k in FRONTEND_CONFIGS:
        exact = SiftFrontend(sift_config(size, S=S), max_keypoints=k, device=dev,
                             use_approx_topk=False)
        want = keyset(exact(frames[size][0]).keypoints)
        got = keyset(feats[size][1][0].keypoints)
        check(len(want) > 0, f"exact branch {size}: no keypoints")
        recall = len(want & got) / len(want)
        check(recall >= RECALL_MIN, f"block-reduce recall {recall:.4f} at {size}")
        ms, mx, n, nk, dms = frame_ms(torch, exact, frames[size]) + device_profile(
            torch, exact, frames[size][0])
        bms, _bmx, _bn, bnk, bdms = timings[size]
        phase("recall", f"{size}^2 K={k}: block-reduce found {recall:.4f} of the exact branch's "
              f"{len(want)} keypoints (gate {RECALL_MIN}); exact branch median {ms:.3f} "
              f"ms/frame, max {mx:.3f} (n={n}), device {dms:.3f} ms in {nk:.0f} ops/frame; "
              f"block-reduce {bms:.3f} ms/frame, device {bdms:.3f} ms in {bnk:.0f} ops/frame")

    # 8. Each path of the main path went through its kernels.
    for path, kernels in PATH_KERNELS.items():
        for name in kernels:
            check(path_launches[path][name] > 0,
                  f"{name} was not launched by the main path's {path} run")
        label = f"frontend {path}^2" if isinstance(path, int) else path
        phase("launches", f"{label}: " + ", ".join(
            f"{name} {n}" for name, n in path_launches[path].items()))
    launches = {name: sum(c[name] for c in path_launches.values()) for name in counters}

    m512, p512 = k2_ms[512][:2]
    m3, p3 = k3_ms["block_top2 512^2 pyramid"][:2]
    m4, p4 = k4_ms[512][:2]
    print(json.dumps({"kernels": [
        {"name": "reference_dog_pyramid", "route": "cuda", "source": SRC_K1,
         "replaces": REPLACES_K1, "launches": launches["reference_dog_pyramid"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "patch_gather", "route": "cuda", "source": SRC_K2,
         "replaces": REPLACES_K2, "launches": launches["patch_gather"], "max_abs_err": k2_err,
         "ms": m512, "plain_ms": p512},
        {"name": "score_tables", "route": "cuda", "source": SRC_K3,
         "replaces": REPLACES_K3, "launches": launches["score_tables"], "max_abs_err": k3_err,
         "ms": m3, "plain_ms": p3},
        {"name": "gather_resample", "route": "cuda", "source": SRC_K4,
         "replaces": REPLACES_K4, "launches": launches["gather_resample"],
         "max_abs_err": k4_err, "ms": m4, "plain_ms": p4},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
