"""The readers of the program's own spans: its host span ring and set-up
record (``utils/profiling``) and the sub-spans inside ``sift.describe``,
on a hand-built run, on a program that keeps none of them, and in CPU runs
of the harness."""

from __future__ import annotations

import pytest

from benchmark import breakdown
from benchmark.tests.conftest import run_on_cpu
from benchmark.tests.test_benchmark_readers import _frame_events, _read, _run, _x
from benchmark.trace import Trace
from sift_parallel_optimization_tpu_torch.utils import profiling

STAGES = ("pyramid", "detect", "describe")
HOST_READERS = [f"{s}_host_ms" for s in STAGES]
PART_READERS = [f"describe_{p}_device_ms" for p in ("sample", "orient", "histogram")]
SETUP_READERS = ["setup_frontend_s", "setup_first_forward_s"]


def _sub_events(t):
    """The sub-spans of a frame at trace time ``t`` (us) and a kernel each
    launched in the orientation and histogram parts (the patch gather of
    ``_frame_events``, launched at t + 65, falls in the sampling part)."""
    return [
        _x("user_annotation", "sift.detect.score", t + 30, 10),
        _x("user_annotation", "sift.describe.sample", t + 60, 10),
        _x("user_annotation", "sift.describe.orient", t + 70, 10),
        _x("user_annotation", "sift.describe.histogram", t + 80, 15),
        _x("cuda_runtime", "cudaLaunchKernel", t + 75, 1, t + 6),
        _x("cuda_runtime", "cudaLaunchKernel", t + 85, 1, t + 7),
        _x("kernel", "orientation_hist", t + 110, 6, t + 6),
        _x("kernel", "descriptor_hist", t + 116, 8, t + 7),
    ]


def _ms(*pairs):
    """Stage spans of one unit: (name, start, end) from (ms after the
    unit's start, ms long) pairs, the unit starting at ``pairs[0]``."""
    t, out = pairs[0], []
    for name, (at, ms) in zip(("sift.pyramid", "sift.detect", "sift.describe"), pairs[1:]):
        out.append((name, t + at / 1e3, t + (at + ms) / 1e3))
    return out


# The ring: a span of the warm-up (before every unit), the traced units'
# (not read) and the two untraced units' (start 2.0 and 3.5 ms), each
# unit's stages (offset from its start in ms, length in ms).
RING = ([("sift.pyramid", -0.5, -0.4)]
        + _ms(0.0, (0.012, 0.018), (0.030, 0.030), (0.060, 0.035))
        + _ms(0.002, (0.1, 0.05), (0.15, 0.1), (0.25, 0.2))
        + _ms(0.0035, (0.01, 0.03), (0.04, 0.06), (0.1, 0.1)))
SETUP = [("sift.setup.frontend", -5.0, -4.0),            # an earlier frontend
         ("sift.setup.frontend", -2.0, -0.5), ("sift.setup.first_forward", -0.4, -0.1),
         ("sift.setup.frontend", 0.5, 0.7)]              # built after the window opened


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(profiling, "host_spans", lambda: list(RING))
    monkeypatch.setattr(profiling, "setup_spans", lambda: list(SETUP))
    r = _run("live", True)
    r.trace = Trace.from_chrome(_frame_events(0.0) + _frame_events(1000.0)
                                + _sub_events(0.0) + _sub_events(1000.0))
    r.t0 = 0.0
    return r


@pytest.mark.parametrize("name,ms", [("pyramid_host_ms", 0.04), ("detect_host_ms", 0.08),
                                     ("describe_host_ms", 0.15)])
def test_stage_host_ms_reads_the_untraced_units_spans(run, name, ms):
    assert _read(run, name) == pytest.approx(ms)


def test_stage_host_ms_sum_within_host_enqueue(run):
    assert sum(_read(run, n) for n in HOST_READERS) <= _read(run, "host_enqueue_ms")


@pytest.mark.parametrize("name,ms", [("describe_sample_device_ms", 0.040),
                                     ("describe_orient_device_ms", 0.006),
                                     ("describe_histogram_device_ms", 0.008)])
def test_describe_part_device_ms(run, name, ms):
    assert _read(run, name) == pytest.approx(ms)
    assert sum(_read(run, n) for n in PART_READERS) == pytest.approx(
        _read(run, "describe_device_ms"))


@pytest.mark.parametrize("name,s", [("setup_frontend_s", 1.5), ("setup_first_forward_s", 0.3)])
def test_setup_reads_the_last_record_before_the_window(run, name, s):
    assert _read(run, name) == pytest.approx(s)


@pytest.mark.parametrize("name", HOST_READERS + SETUP_READERS)
@pytest.mark.parametrize("program", ["no_record", "empty_record"])
def test_span_record_readers_return_nothing_without_a_record(monkeypatch, name, program):
    run = _run("live", True)
    for record in ("host_spans", "setup_spans"):
        if program == "no_record":
            monkeypatch.delattr(profiling, record)
        else:
            monkeypatch.setattr(profiling, record, lambda: [])
    assert _read(run, name) is None


@pytest.mark.parametrize("name", PART_READERS)
def test_part_readers_return_nothing_without_sub_spans(name):
    assert _read(_run("live", True), name) is None


def test_breakdown_names_idle_gaps_by_sub_span(run):
    gaps = dict(breakdown.of(run.trace, 0.0, 1200.0)["idle_gaps"])
    want = {"bench.upload": 8, "sift.pyramid": 16, "sift.detect.score": 20,
            "sift.describe.sample": 20, "outside spans": 884, "bench.sync": 76}
    assert gaps == pytest.approx({k: v / 1e6 for k, v in want.items()})


@pytest.mark.parametrize("cell,split", [("tiny_live", "live"), ("tiny_offline", "offline")])
def test_traced_cpu_run_reports_the_span_record_metrics(tiny_root, capsys, cell, split):
    out = run_on_cpu(tiny_root, cell, capsys, seconds=0.5, trace=1)
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    host = [metrics[f"{n}.{split}"] for n in HOST_READERS]
    assert all(v > 0 for v in host)
    assert sum(host) <= metrics[f"host_enqueue_ms.{split}"]
    assert all(metrics[n] > 0 for n in SETUP_READERS)
    assert out["correct"] is True
