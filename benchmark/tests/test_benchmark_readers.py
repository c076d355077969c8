"""The per-layer readers on a small synthetic profiler trace."""

from __future__ import annotations

import types

import numpy as np
import pytest

from benchmark import breakdown, roofline, spec
from benchmark.run import Run
from benchmark.trace import Trace

CFG = {"S": 3, "sigma0": 1.6, "max_keypoints": 4}
OCTAVES = [(60, 80), (30, 40)]


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _frame_events(t):
    """One frame at trace time ``t`` (us): a copy launched in the upload,
    one kernel launched in each of the program's three spans, a host wait."""
    return [
        _x("user_annotation", "bench.upload", t, 10),
        _x("user_annotation", "bench.forward", t + 10, 90),
        _x("user_annotation", "sift.pyramid", t + 12, 18),
        _x("user_annotation", "sift.detect", t + 30, 30),
        _x("user_annotation", "sift.describe", t + 60, 35),
        _x("user_annotation", "bench.sync", t + 100, 100),
        _x("cuda_runtime", "cudaMemcpyAsync", t + 5, 1, t + 4),
        _x("cuda_runtime", "cudaLaunchKernel", t + 14, 1, t + 1),
        _x("cuda_runtime", "cudaLaunchKernel", t + 35, 1, t + 2),
        _x("cuda_runtime", "cudaLaunchKernel", t + 65, 1, t + 3),
        _x("cuda_runtime", "cudaEventRecord", t + 99, 1, t + 5),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t + 8, 4, t + 4),
        _x("kernel", "blur", t + 20, 10, t + 1),
        _x("kernel", "void score_block_top2_kernel(float const*)", t + 40, 20, t + 2),
        _x("kernel", "void patch_gather_kernel(float const*)", t + 70, 40, t + 3),
        _x("cpu_op", "aten::add", t + 15, 2),
    ]


def _run(split: str, live: bool) -> Run:
    cell = types.SimpleNamespace(config=CFG, mix={"batch": 1})
    run = Run(cell, types.SimpleNamespace(seconds=1.0), OCTAVES)
    run.trace = Trace.from_chrome(_frame_events(0.0) + _frame_events(1000.0))
    run.device_name = roofline.H100_SXM.name
    run.metric = f"x.{split}"
    run.units = []
    for t in (0.0, 1000.0):
        u = {"start": t / 1e6, "returned": (t + 100) / 1e6, "done": (t + 200) / 1e6, "frames": 1}
        if live:
            u["due"] = (t - 50) / 1e6
        run.units.append(u)
    run.units.append({"start": 0.002, "returned": 0.0025, "due": 0.002, "done": 0.003,
                      "frames": 1})
    run.units.append({"start": 0.0035, "returned": 0.0038, "due": 0.0035, "done": 0.004,
                      "frames": 1})
    run.traced = range(0, 2)
    run.trace_window = (0.0, 1200.0)
    return run


def _read(run, name):
    run.metric = f"{name}.{run.metric.split('.', 1)[1]}"
    return spec.reader(run.metric).read(run)


@pytest.mark.parametrize("stage,ms", [("pyramid", 0.010), ("detect", 0.020),
                                      ("describe", 0.040)])
def test_stage_device_ms(stage, ms):
    assert _read(_run("live", True), f"{stage}_device_ms") == pytest.approx(ms)


def test_launches_per_frame_counts_launches_and_copies_only():
    assert _read(_run("live", True), "launches_per_frame") == pytest.approx(4.0)


def test_idle_share_over_the_traced_service_spans():
    # Busy a frame: the copy 4 us, the kernels 10 + 20 + 40 us. Live: each
    # traced frame's service span runs from its due time (50 us before its
    # upload) to its completion, 250 us; offline: the traced window, 1200 us.
    live = _read(_run("live", True), "device_idle_pct")
    assert live == pytest.approx(100 * (1 - 148.0 / 500.0))
    late = _run("live", True)
    late.units[1]["due"] = 500e-6           # due 500 us before its upload
    assert _read(late, "device_idle_pct") == pytest.approx(100 * (1 - 148.0 / 950.0))
    offline = _read(_run("offline", False), "device_idle_pct")
    assert offline == pytest.approx(100 * (1 - 148.0 / 1200.0))


def test_host_enqueue_reads_the_untraced_units():
    assert _read(_run("live", True), "host_enqueue_ms") == pytest.approx(0.4)


def test_score_tables_roofline():
    want = roofline.score_tables_model([(5, h, w) for h, w in OCTAVES], 1).floor_ms(
        roofline.H100_SXM)
    assert _read(_run("live", True), "score_tables_roofline") == pytest.approx(
        100 * want / 0.020)


def test_patch_gather_roofline_counts_the_units_keypoints():
    run = _run("live", True)
    kp = {"x": np.array([10.0, 20.0, 0.0, 0.0, 5, 5, 5, 5]),
          "y": np.array([10.0, 40.0, 0.0, 0.0, 5, 5, 5, 5]),
          "octave": np.array([0, 1, 0, 0, 0, 0, 0, 0]),
          "scale": np.array([1, 2, 1, 1, 1, 1, 1, 1])}
    run.traced_keypoints = {0: [kp], 1: [kp]}
    lay = roofline.atlas_layout([(6, h, w) for h, w in OCTAVES])
    radius = roofline.max_patch_radius(3, 1.6)
    rows = roofline.patch_rows_for(radius)
    prim = {k: v[:4] for k, v in kp.items()}
    ys, xs = roofline.patch_origins(lay, prim, radius, rows)
    foot = roofline.patch_footprint_bytes(lay["n_rows"], lay["n_cols"], ys, xs, rows, 256)
    floor = roofline.patch_gather_model(4, rows, 256, lay["n_rows"] * lay["n_cols"],
                                        foot).floor_ms(roofline.H100_SXM)
    assert _read(run, "patch_gather_roofline") == pytest.approx(100 * floor / 0.040)


@pytest.mark.parametrize("name", ["pyramid_device_ms", "score_tables_roofline",
                                  "device_idle_pct", "launches_per_frame"])
def test_readers_return_nothing_without_device_records(name):
    run = _run("live", True)
    run.trace = Trace.from_chrome([e for e in _frame_events(0.0) if e["cat"] != "kernel"
                                   and e["cat"] != "gpu_memcpy"])
    assert _read(run, name) is None


def test_breakdown_names_ops_and_idle_gaps():
    run = _run("live", True)
    out = breakdown.of(run.trace, 0.0, 1200.0)
    ops = dict(out["device_ops"])
    assert ops["void patch_gather_kernel(float const*)"] == pytest.approx(80e-6)
    gaps = dict(out["idle_gaps"])
    want = {"bench.upload": 8, "sift.pyramid": 16, "sift.detect": 20, "sift.describe": 20,
            "outside spans": 898, "bench.sync": 90}
    assert gaps == pytest.approx({k: v / 1e6 for k, v in want.items()})
