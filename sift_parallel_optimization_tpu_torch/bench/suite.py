"""Benchmark matrix of the port (port of ``bench/suite.py``).

The JAX suite's workloads, record names and fields, measured on the card:
each workload is a function ``bench_*(writer, device="cuda", ...)`` that
writes JSONL records through ``utils/profiling.MetricsWriter``. Kernel and
stage times are chained slopes (``utils/profiling.chained_slope_ms``): on
the card each chain length is ONE captured CUDA graph, replayed, so the
slope is the device's time a step with no host enqueue in it (a per-call
wall of ``chip_smoke.py`` holds the host's ~15-20 us a launch). The
tracking step replays its own graph (``models/odometry.SteadyStepRunner``)
and takes the slope between a short and a long run of replays; the stream
is a wall over its frames, host included, as in JAX.

Workloads: ``pyramid`` (REFERENCE pyramid+DoG; variants ``cuda``, kernel 1,
and ``plain``, the plain PyTorch version on the same device, in place of
JAX's ``pallas`` and ``jnp``), ``frontend``, ``stages``, ``stream``,
``tracking``, ``matching``, ``ba``, ``matrix``, ``scaling``
(``bench/scaling.py``: rank groups of the data-parallel frontend, and the
sharded pyramid's link bytes).

Every record has the JAX record's fields plus ``device`` (the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, or ``cpu``) and ``backend`` (``cuda`` or
``cpu``); every chained record also ``chain`` ([short, long] chain
lengths; replays for tracking), ``capture_s`` (seconds spent capturing
graphs), ``peak_mib`` (the measurement's peak device memory above what
was allocated before it) and ``sm_mhz`` ([least, most] SM clock that
nvidia-smi sampled every 20 ms while the chains ran), None on the CPU;
the pyramid records also ``device_ms``, the device time of one pyramid
call alone from one ``profile_device`` run (the chain adds a reduction per
octave and an update to every step); the tracking records ``device_ms``
and ``device_top`` (the device time of a replayed frame and its costliest
kernels, from the records ``profile_device`` counts). Floors and shares come
from ``bench/roofline.py`` with the attached part's peaks; on the CPU they
are None (``sol_pct``, ``bound``, ``floor_ms``).

Two sweeps of the JAX ``bench_matrix`` have no record here: the Pallas
``tile_rows`` sweep (JAX runs it only on a TPU; kernel 1 has no such knob)
and ``blur_precision="high"`` (the port refuses it by design: every blur is
full fp32, ``config.PyramidConfig``). The frame-batch sweep's ``per_frame``
path, a loop of ``SiftFrontend`` calls, is the port's form of JAX's ``vmap``
path (each record says so in ``jax_path``). The mesh-shape sweep runs over
every (data, spatial) factorization of the default process group's world
size (one process: 1x1, the group formed and destroyed by the sweep),
each shape through the same captured chains as every other record (the
NCCL calls of a 1x1 mesh capture on the card); a capture that is refused
raises.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from sift_parallel_optimization_tpu_torch.bench import roofline as R
from sift_parallel_optimization_tpu_torch.utils.device import resolve_device
from sift_parallel_optimization_tpu_torch.utils.profiling import (
    MetricsWriter,
    chained_slope_ms,
    device_breakdown,
    profile_device,
    slope_ms,
    sm_clock_samples,
)

WORKLOADS = ("pyramid", "frontend", "stages", "stream", "tracking", "matching", "ba", "matrix",
             "scaling")


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class _Records:
    """A writer bound to one device: adds ``device`` and ``backend`` to
    every record and reads floors against the device's peaks."""

    def __init__(self, writer: MetricsWriter, device):
        self.dev = resolve_device(device)
        self.peaks = R.device_peaks(self.dev)
        self.writer = writer
        self.common = {"device": device_label(self.dev), "backend": self.dev.type}

    def write(self, metric: str, value, unit: str, **extra) -> None:
        self.writer.write(metric, value, unit, **extra, **self.common)

    def roofline(self, model: R.CostModel, ms: float) -> dict:
        floor = model.floor_ms(self.peaks)
        return {"sol_pct": model.sol_pct(ms, self.peaks), "bound": model.bound(self.peaks),
                "floor_ms": None if floor is None else round(floor, 4)}

    def slope(self, step, example, **kw) -> tuple[float, dict]:
        """(chained slope ms, its chain fields for the record)."""
        info: dict = {}
        with sm_clock_samples(self.dev) as clock:
            ms = chained_slope_ms(step, example, info=info, **kw)
        return ms, _chain_fields({**info, **clock})

    def device_ms(self, fn, *args) -> float | None:
        if self.dev.type != "cuda":
            return None
        return round(profile_device(fn, *args, warmup=3, iters=20)[1], 4)


def _chain_fields(info: dict) -> dict:
    mib = info.get("peak_mib")
    return {"chain": info.get("chain"), "capture_s": _round(info.get("capture_s"), 3),
            "peak_mib": _round(mib, 1), "sm_mhz": info.get("sm_mhz")}


def _round(v, digits):
    return None if v is None else round(v, digits)


def _rand_img(size: int, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).random((size, size), np.float32)).to(dev)


def _fps(ms: float) -> float:
    return round(1e3 / max(ms, 1e-6), 1)


def bench_pyramid(writer: MetricsWriter, sizes=(256, 512, 1024), S: int = 2, variants=None,
                  device="cuda", **kw) -> None:
    from sift_parallel_optimization_tpu_torch.ops import scale_space

    rec = _Records(writer, device)
    if variants is None:
        # Kernel 1 runs only on the card; a CPU tensor takes the plain path.
        variants = ("plain", "cuda") if rec.dev.type == "cuda" else ("plain",)
    impls = {"cuda": scale_space.reference_dog_pyramid,
             "plain": scale_space.reference_dog_pyramid_plain}
    for size in sizes:
        img = _rand_img(size, rec.dev)
        model = R.reference_pyramid_model(size, S)
        for variant in variants:
            impl = impls[variant]

            def step(x, impl=impl):
                return sum(o.sum() for o in impl(x, S))

            ms, chain = rec.slope(step, img)
            rec.write(f"pyramid_dog_ms_per_frame_{size}", round(ms, 4), "ms",
                      variant=variant, S=S, frames_per_s=_fps(ms), **rec.roofline(model, ms),
                      device_ms=rec.device_ms(impl, img, S), **chain)


def bench_frontend(writer: MetricsWriter, sizes=(256, 512), max_keypoints: int = 512,
                   device="cuda", **kw) -> None:
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config

    rec = _Records(writer, device)
    for dual in (False, True):
        # Dual orientations: the configuration the SfM / odometry gates run.
        for size in sizes:
            cfg = sift_config(size)
            fe = SiftFrontend(cfg, max_keypoints=max_keypoints, dual_orientation=dual,
                              device=rec.dev)

            def step(x, fe=fe):
                f = fe(x)
                return f.descriptors.sum() + f.keypoints.score.sum()

            ms, chain = rec.slope(step, _rand_img(size, rec.dev), chain_lo=30, chain_hi=150)
            roof = {} if dual else rec.roofline(R.frontend_model(cfg, max_keypoints), ms)
            rec.write(f"frontend{'_dual' if dual else ''}_ms_per_frame_{size}", round(ms, 4),
                      "ms", max_keypoints=max_keypoints, frames_per_s=_fps(ms), **roof, **chain)


def bench_stages(writer: MetricsWriter, size: int = 512, max_keypoints: int = 512,
                 device="cuda", **kw) -> None:
    """Frontend stage decomposition with %SOL per stage, as deltas between
    nested cumulative programs (pyramid; + dense score; + detection; +
    descriptors). The dense score is the one detection runs on the device:
    on the card kernel 3's score tables (detection's block-reduce branch;
    the plain ``dense_score`` is not on that path and costs more than the
    whole detection), on the CPU ``models/detect.dense_score`` (the exact
    branch). Chains of 10 / 50 steps, stretched until the long one takes
    60 ms (the JAX suite's 50 / 400 would put ~216k kernels of the frontend
    into one graph)."""
    from sift_parallel_optimization_tpu_torch.models.detect import (
        CONTRAST_THRESHOLD,
        EDGE_RATIO,
        dense_score,
        detect_pyramid,
    )
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
    from sift_parallel_optimization_tpu_torch.ops.score_tables import score_block_top2

    rec = _Records(writer, device)
    cfg = sift_config(size)
    img = _rand_img(size, rec.dev)
    models = R.stage_models(cfg, max_keypoints)
    fe = SiftFrontend(cfg, max_keypoints=max_keypoints, device=rec.dev)

    def dogs(x):
        return [g[1:] - g[:-1] for g in fe.pyramid(x)]

    def pyr(x):
        return sum(o.sum() for o in fe.pyramid(x))

    thr = CONTRAST_THRESHOLD / cfg.S

    def score(x):
        ds = dogs(x)
        if x.is_cuda:
            flat = torch.cat([d.reshape(1, -1) for d in ds], dim=1)
            tables = score_block_top2(flat, [tuple(d.shape) for d in ds], thr, EDGE_RATIO, 1)
            return sum(t.to(torch.float32).sum() for t in tables)
        return sum(dense_score(d, thr, EDGE_RATIO, 1).sum() for d in ds)

    def detect(x):
        kp = detect_pyramid(dogs(x), cfg, max_keypoints=max_keypoints)
        return kp.score.sum() + kp.x.sum()

    def frontend(x):
        f = fe(x)
        return f.descriptors.sum() + f.keypoints.score.sum()

    t, chains = {}, {}
    for name, fn in (("pyramid", pyr), ("score", score), ("detect", detect),
                     ("frontend", frontend)):
        t[name], chains[name] = rec.slope(fn, img, chain_lo=10, chain_hi=50,
                                          min_hi_total_ms=60, median_of=3)
    stage_ms = {
        "pyramid": (t["pyramid"], "pyramid"),
        "dense_score": (t["score"] - t["pyramid"], "score"),
        "refit": (t["detect"] - t["score"], "detect"),  # extraction + refit tail
        "descriptors": (t["frontend"] - t["detect"], "frontend"),
        "frontend": (t["frontend"], "frontend"),
    }
    for stage, (ms, program) in stage_ms.items():
        rec.write(f"stage_{stage}_ms_{size}", round(ms, 4), "ms",
                  **rec.roofline(models[stage], ms), max_keypoints=max_keypoints,
                  **chains[program])


def bench_matching(writer: MetricsWriter, k: int = 512, device="cuda", **kw) -> None:
    """Matching and RANSAC at K slots. The RANSAC draws one fixed
    ``sample_idx``, built once outside the chain: the JAX step draws with
    one fixed key every iteration, and a capture refuses a draw from a
    generator it does not know."""
    from sift_parallel_optimization_tpu_torch.models.matching import (
        _sample_indices,
        match_descriptors,
        ransac_homography,
    )

    rec = _Records(writer, device)
    rng = np.random.default_rng(0)
    d1 = rng.normal(size=(k, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = torch.from_numpy(np.roll(d1, 7, axis=0)).to(rec.dev)
    d1 = torch.from_numpy(d1).to(rec.dev)
    v = torch.ones(k, dtype=torch.bool, device=rec.dev)
    p1 = torch.from_numpy(rng.uniform(0, 512, (k, 2)).astype(np.float32)).to(rec.dev)
    p2 = p1 + 5.0
    idx = _sample_indices(torch.Generator(device=rec.dev).manual_seed(0), v, 256, 4)

    def match_step(x):
        return match_descriptors(d1 + 1e-12 * x.sum(), d2, v, v).similarity.sum()

    ms, chain = rec.slope(match_step, d1, chain_lo=30, chain_hi=200)
    rec.write(f"match_ms_{k}x{k}", round(ms, 4), "ms", **rec.roofline(R.matching_model(k), ms),
              **chain)

    def ransac_step(x):
        r = ransac_homography(None, p1 + 1e-12 * x.sum(), p2, v, 256, sample_idx=idx)
        return r.model.sum() + r.n_inliers.to(torch.float32)

    ms, chain = rec.slope(ransac_step, p1, chain_lo=30, chain_hi=200)
    rec.write(f"ransac_homography_ms_{k}", round(ms, 4), "ms", **chain)


def bench_ba(writer: MetricsWriter, n_cams: int = 20, n_pts: int = 500, n_iters: int = 10,
             solvers=("dense", "cg"), device="cuda", **kw) -> None:
    from sift_parallel_optimization_tpu_torch.models.ba import (
        BAState,
        Observations,
        bundle_adjust,
    )
    from sift_parallel_optimization_tpu_torch.models.geometry import project

    rec = _Records(writer, device)
    dev = rec.dev
    K = torch.tensor([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], device=dev)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)).to(dev)
    pts[:, 2] += 8.0
    rvecs = torch.from_numpy(rng.normal(size=(n_cams, 3)).astype(np.float32) * 0.02).to(dev)
    tvecs = torch.from_numpy(np.stack(
        [np.linspace(-2, 2, n_cams), np.zeros(n_cams), np.zeros(n_cams)], 1
    ).astype(np.float32)).to(dev)
    uv = torch.cat([project(pts, rvecs[i], tvecs[i], K)[0] for i in range(n_cams)])
    obs = Observations(
        cam_idx=torch.arange(n_cams, dtype=torch.int32, device=dev).repeat_interleave(n_pts),
        pt_idx=torch.arange(n_pts, dtype=torch.int32, device=dev).repeat(n_cams),
        uv=uv, valid=torch.ones(n_cams * n_pts, dtype=torch.bool, device=dev),
    )
    state = BAState(rvecs=rvecs + 0.005, tvecs=tvecs + 0.01, points=pts + 0.02)

    for solver in solvers:
        def step(x, solver=solver):
            st = state._replace(points=state.points + 1e-12 * x.sum())
            out = bundle_adjust(st, obs, K, n_iters=n_iters, solver=solver)
            return out.points.sum() + out.tvecs.sum()

        ms, chain = rec.slope(step, pts, chain_lo=3, chain_hi=12, repeats=2)
        rec.write(f"ba_ms_{n_cams}cams_{n_pts}pts_{n_iters}iters", round(ms, 2), "ms",
                  obs=n_cams * n_pts, solver=solver, **chain)


def bench_stream(writer: MetricsWriter, size: int = 512, frames: int = 200,
                 max_keypoints: int = 512, device="cuda", **kw) -> None:
    """End-to-end serving throughput: ``cli.serve_stream`` (the host
    library's ring loader -> pinned, non-blocking upload -> SiftFrontend
    with dual orientations), one read of the keypoint counts at the end.
    A wall clock over the frames, host included: what a served camera
    waits for."""
    from sift_parallel_optimization_tpu_torch.cli import serve_stream
    from sift_parallel_optimization_tpu_torch.utils import native

    rec = _Records(writer, device)
    if not native.available():
        raise RuntimeError(f"bench stream needs the host library: {native.build_error()}")
    res = serve_stream(frames, size, max_keypoints, seed=0, dual_orientation=True,
                       device=rec.dev)
    dt = res["seconds"]
    rec.write(f"stream_fps_{size}", round(frames / dt, 1), "frames/s", frames=frames,
              dual_orientation=True, ms_per_frame=round(1e3 * dt / frames, 3),
              keypoints_per_frame=round(res["keypoints"] / frames, 1), chain=None)


def _replay_slope(runner, i: int, do_loop: bool, generator, lo: int = 4, hi: int = 16,
                  repeats: int = 4, min_hi_total_ms: float = 60.0) -> tuple[float, dict]:
    """ms a frame of ``runner``'s steady step at frame index ``i`` (BA on),
    from the slope between runs of ``lo`` and ``hi`` frames
    (``utils/profiling.slope_ms``). Every run starts from the same carry and
    the same generator state (both restored outside the graph), so every run
    replays the same frames and draws, as every JAX chain starts from the
    same map and key. On the card the first frame warms the step up, the
    second captures it, and the timed frames replay the graph; then one
    profiled run of three frames gives the device time a frame and its
    kernels (``device_ms``, ``device_top``)."""
    from sift_parallel_optimization_tpu_torch.models.odometry import _clone, _tensors

    dev = runner.u.device
    on_card = dev.type == "cuda"
    start, draws = _clone(runner.carry), generator.get_state()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def restore():
        for dst, src in zip(_tensors(runner.carry), _tensors(start)):
            dst.copy_(src)
        generator.set_state(draws)
        sync()

    def frame():
        runner.run(i, True, do_loop, generator=generator)

    def run_of(n: int):
        def run():
            for _ in range(n):
                frame()
            sync()
        return run

    restore()
    frame()                                   # eager warm-up (the card)
    sync()
    t0 = time.perf_counter()
    frame()                                   # capture + first replay (the card)
    sync()
    capture_s = time.perf_counter() - t0
    with sm_clock_samples(dev) as clock:
        ms, chain = slope_ms(run_of, lo, hi, repeats=repeats,
                             min_hi_total_ms=min_hi_total_ms, before=restore)
    fields = {"chain": chain, "capture_s": round(capture_s, 3) if on_card else None,
              "peak_mib": round((torch.cuda.max_memory_allocated(dev) - base) / 2**20, 1)
              if on_card else None, "sm_mhz": clock["sm_mhz"],
              "device_ms": None, "device_top": None}
    if on_card:
        restore()
        dev_ms, top = device_breakdown(frame, warmup=1, iters=3)
        fields["device_ms"] = round(dev_ms, 4)
        fields["device_top"] = [
            [name.replace("void ", "").replace("at::native::", "")[:120], round(t, 4), n]
            for name, t, n in top]
    restore()
    return max(ms, 1e-6), fields


def bench_tracking(writer: MetricsWriter, size: int = 256, window: int = 6,
                   pts_per_frame: int = 128, ba_iters: int = 4, device="cuda", **kw) -> None:
    """Steady-state odometry TRACKING step: ``models/odometry.
    make_steady_step`` (anchor harvest + shift + register at slot W-1 +
    anchored window BA every frame), the program ``run_odometry`` replays
    once the window is full, run by ``SteadyStepRunner`` (one CUDA graph a
    frame on the card). Then the loop-closed step against a full archive
    of 64 * B landmarks (``tracking_loop_ms_per_frame``).

    Frames 0-2 are rendered views of the host library's blob cloud (the
    JAX suite's); frame 2 is registered against frame 1 every step, and the
    loop step registers frame 2 against itself at frame index W + 1, as the
    JAX chain's clamped gathers do."""
    from sift_parallel_optimization_tpu_torch.models.ba import empty_anchors
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
    from sift_parallel_optimization_tpu_torch.models.odometry import (
        OdometryCarry,
        SteadyStepRunner,
        _clone,
        _window_ba_kwargs,
        empty_archive,
        empty_loop_buffer,
        make_steady_step,
    )
    from sift_parallel_optimization_tpu_torch.models.sfm import (
        empty_map,
        init_two_view,
        register_frame,
    )
    from sift_parallel_optimization_tpu_torch.utils import native

    rec = _Records(writer, device)
    dev = rec.dev
    W, B = window, pts_per_frame
    focal = float(size)
    K = torch.tensor([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]], device=dev)
    fe = SiftFrontend(sift_config(size), max_keypoints=2 * B, dual_orientation=True, device=dev)
    feats = [
        fe(torch.from_numpy(native.render_frame(
            size, np.array([0.0, 0.02 * i, 0.0], np.float32),
            np.array([-0.3 * i, 0.0, 0.03 * i], np.float32), focal, seed=2)).to(dev))
        for i in range(3)
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    m = empty_map(W, B, max_loops=0, device=dev)
    m, used = init_two_view(gen, feats[0], feats[1], K, m, B)
    m, used = register_frame(gen, m, feats[2], feats[1], 2, K, used, B)
    ba_kwargs = _window_ba_kwargs(W, B, "auto", 1e-4, 2.0)
    graph = dev.type == "cuda"

    def runner_for(loop_closure: bool, i: int, arch=None, buf=None):
        step = make_steady_step(K, window=W, pts_per_frame=B, ba_iters=ba_iters,
                                ba_kwargs=ba_kwargs, marginalize=True,
                                loop_closure=loop_closure, loop_min_gap=W + 1)
        # Each runner updates its carry in place: give it a copy of its own.
        carry = _clone(OdometryCarry(m, used, empty_anchors((W - 1) * B, device=dev), arch, buf))
        runner = SteadyStepRunner(step, carry, graph, ring=feats[2])
        prev = feats[2] if loop_closure else feats[1]
        runner.feed(i, feats[2])
        runner.feed(i - 1, prev)
        return runner

    cost = R.tracking_step_cost(window=W, pts_per_frame=B, desc_capacity=2 * B,
                                ba_iters=ba_iters)
    ms, chain = _replay_slope(runner_for(False, 2), 2, False, gen)
    common = dict(window=W, pts_per_frame=B, ba_iters=ba_iters, solver=ba_kwargs["solver"])
    rec.write(f"tracking_ms_per_frame_{size}", round(ms, 3), "ms", **common,
              frames_per_s=_fps(ms), **rec.roofline(cost, ms), **chain)

    # The loop-closed step: archive write + harvest + shift + register + BA
    # + archive-PnP propose / accept against a FULL ring of 64 * B archived
    # landmarks, so the product and its RANSAC run at their real size.
    A = 64 * B
    rngl = np.random.default_rng(1)
    d = rngl.normal(size=(A, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    arch = empty_archive(A, device=dev)._replace(
        positions=torch.from_numpy(
            rngl.normal(size=(A, 3)).astype(np.float32) + np.float32([0, 0, 5])).to(dev),
        desc=torch.from_numpy(d).to(dev),
        valid=torch.ones(A, dtype=torch.bool, device=dev),
    )
    ms_lc, chain = _replay_slope(
        runner_for(True, W + 1, arch, empty_loop_buffer(64, device=dev)), W + 1, True, gen)
    lcost = R.loop_stage_cost(desc_capacity=2 * B, archive_slots=A)
    floor = cost.floor_ms(rec.peaks)
    floor_lc = None if floor is None else floor + lcost.floor_ms(rec.peaks)
    rec.write(f"tracking_loop_ms_per_frame_{size}", round(ms_lc, 3), "ms", **common,
              archive_slots=A, frames_per_s=_fps(ms_lc),
              loop_overhead_ms=round(ms_lc - ms, 3),
              floor_ms=None if floor_lc is None else round(floor_lc, 4),
              sol_pct=None if floor_lc is None else round(100.0 * floor_lc / max(ms_lc, 1e-9), 1),
              **chain)


def bench_matrix(writer: MetricsWriter, size: int = 512, device="cuda", **kw) -> None:
    """The knob sweep (the reference's schedule / chunk-size study): the
    compute dtype of the SIFT pyramid (float32, bfloat16) and the frame
    batch of the frontend (B in 1, 2, 4, 8 at min(size, 256)^2, K=256) on
    two paths: ``batched`` (one SiftFrontend call on (B, H, W), the body of
    ``parallel/frontend.batched_extract_features`` with its matrices held:
    kernels 3 and 2b once a batch) and ``per_frame`` (B calls of the
    frontend on (H, W): kernels 3 and 2a once a frame, the port's form of
    JAX's ``vmap`` path); then the sharded SIFT pyramid on every mesh shape
    of the world size. The module docstring lists the JAX sweeps that have
    no record here."""
    from sift_parallel_optimization_tpu_torch.core.pyramid_ref import SiftPyramid
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config

    rec = _Records(writer, device)
    img = _rand_img(size, rec.dev)
    for dtype_name in ("float32", "bfloat16"):
        pyr = SiftPyramid(sift_config(size, dtype=getattr(torch, dtype_name)), size,
                          device=rec.dev)

        def step(x, pyr=pyr):
            return sum(o.to(torch.float32).sum() for o in pyr(x))

        ms, chain = rec.slope(step, img)
        rec.write(f"matrix_sift_pyramid_ms_{size}", round(ms, 4), "ms", dtype=dtype_name,
                  **chain)

    bsize = min(size, 256)
    fe = SiftFrontend(sift_config(bsize), max_keypoints=256, device=rec.dev)

    def batched(x):
        f = fe(x)
        return f.descriptors.sum() + f.keypoints.score.sum()

    def per_frame(x):
        return sum(batched(x[b]) for b in range(x.shape[0]))

    for batch in (1, 2, 4, 8):
        frames = torch.from_numpy(np.random.default_rng(1).random(
            (batch, bsize, bsize), np.float32)).to(rec.dev)
        for path, jax_path, fn in (("per_frame", "vmap", per_frame),
                                   ("batched", "batched", batched)):
            ms, chain = rec.slope(fn, frames, chain_lo=10, chain_hi=40)
            rec.write(f"matrix_frontend_batched_ms_per_frame_{bsize}", round(ms / batch, 4),
                      "ms", batch=batch, path=path, jax_path=jax_path, **chain)
    _mesh_sweep(rec, img, size)


def _mesh_sweep(rec: _Records, img: torch.Tensor, size: int) -> None:
    """The sharded SIFT pyramid on every (data, spatial) factorization of
    the world size, under the default process group (formed here for one
    process, and destroyed after, if none exists)."""
    import torch.distributed as dist

    from sift_parallel_optimization_tpu_torch.models.frontend import sift_config
    from sift_parallel_optimization_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
    )
    from sift_parallel_optimization_tpu_torch.parallel.scale_space import ShardedSiftPyramid

    formed = not dist.is_initialized()
    initialize_distributed(device=rec.dev)
    try:
        n = dist.get_world_size()
        for n_data in (d for d in (1, 2, 4, 8, 16) if d <= n and n % d == 0):
            mesh = make_mesh(n_data, n // n_data)
            pyr = ShardedSiftPyramid(sift_config(size), size, size, mesh, device=rec.dev)

            def step(x, pyr=pyr):
                return sum(o.to_local().sum() for o in pyr(x))

            ms, chain = rec.slope(step, img)
            rec.write(f"matrix_mesh_shape_pyramid_ms_{size}", round(ms, 4), "ms",
                      mesh=f"{n_data}x{n // n_data}", **chain)
    finally:
        if formed:
            dist.destroy_process_group()


def run_suite(writer: MetricsWriter, workloads=WORKLOADS, size: int | None = None,
              **kw) -> None:
    """Run ``workloads`` in the JAX suite's order. ``size``, if given, is the
    one frame side of every sized workload (default: each workload's own
    sizes: pyramid 256/512/1024, frontend 256/512, tracking 256 and 512,
    stages / stream / matrix 512, scaling 256). ``kw`` goes to every workload
    (``device``: "cuda" by default)."""
    unknown = [w for w in workloads if w not in WORKLOADS]
    if unknown:
        raise ValueError(f"unknown workloads {unknown}; choose from {', '.join(WORKLOADS)}")
    sized = {} if size is None else {"size": size, "sizes": (size,)}
    if "pyramid" in workloads:
        bench_pyramid(writer, **sized, **kw)
    if "frontend" in workloads:
        bench_frontend(writer, **sized, **kw)
    if "stages" in workloads:
        bench_stages(writer, **sized, **kw)
    if "stream" in workloads:
        bench_stream(writer, **sized, **kw)
    if "tracking" in workloads:
        # 512^2 too: the frame size changes only the frontend, but the
        # registration's PnP sees twice the pixel spread.
        for s in (256, 512) if size is None else (size,):
            bench_tracking(writer, **{**kw, "size": s})
    if "matching" in workloads:
        bench_matching(writer, **kw)
    if "ba" in workloads:
        bench_ba(writer, **kw)
    if "matrix" in workloads:
        bench_matrix(writer, **sized, **kw)
    if "scaling" in workloads:
        from sift_parallel_optimization_tpu_torch.bench.scaling import bench_scaling

        bench_scaling(writer, **sized, **kw)
