"""The port's wall-clock timer, spans and metrics sink
(``utils/profiling``) on the CPU, against the JAX package's where both
produce the same thing, and the spans the frontend records. The card-only
timers (``cuda_time_ms``, ``profile_device``) are tested in
test_torch_package.py (they refuse the CPU) and on the card."""

import contextlib
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sift_parallel_optimization_tpu.utils import profiling as jprof
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.utils import profiling as tprof


def test_metrics_writer_records_equal_jax(tmp_path):
    """The same calls write the same JSONL lines, to a file and to stdout."""
    recs = [("frontend_ms_per_frame", 11.25, "ms", {"size": 512, "device": "cpu"}),
            ("fps", 88.9, "frames/s", {})]
    paths = {}
    for name, mod in (("port", tprof), ("jax", jprof)):
        paths[name] = tmp_path / f"{name}.jsonl"
        with mod.MetricsWriter(str(paths[name])) as w:
            for metric, value, unit, extra in recs:
                w.write(metric, value, unit, **extra)
    text = paths["port"].read_text()
    assert text == paths["jax"].read_text()
    assert json.loads(text.splitlines()[0]) == {
        "metric": "frontend_ms_per_frame", "value": 11.25, "unit": "ms", "size": 512,
        "device": "cpu"}


def test_metrics_writer_to_stdout(capsys):
    w = tprof.MetricsWriter()
    w.write("x", 1.0, "ms")
    w.close()
    assert json.loads(capsys.readouterr().out) == {"metric": "x", "value": 1.0, "unit": "ms"}


def _light(c):
    return c.sum()


def _heavy(c):
    return (c @ c @ c).sum() * 1e-9


def test_chained_slope_ms_orders_a_heavier_step_above_a_lighter():
    x = torch.rand(192, 192, generator=torch.Generator().manual_seed(0))
    kw = dict(chain_lo=4, chain_hi=16, repeats=2, median_of=3)
    light = tprof.chained_slope_ms(_light, x, **kw)
    heavy = tprof.chained_slope_ms(_heavy, x, **kw)
    assert 0 <= light < heavy < 1e3
    # A pilot run stretches both chains until the long one takes 20 ms.
    assert tprof.chained_slope_ms(_heavy, x, chain_lo=1, chain_hi=2, repeats=1,
                                  min_hi_total_ms=20.0) > 0


STAGES = ("sift.pyramid", "sift.detect", "sift.describe")
# Each sub-span with the stage span it runs in.
SUB_SPANS = {"sift.detect.dog": "sift.detect", "sift.detect.score": "sift.detect",
             "sift.detect.select": "sift.detect", "sift.detect.refit": "sift.detect",
             "sift.describe.sample": "sift.describe", "sift.describe.orient": "sift.describe",
             "sift.describe.histogram": "sift.describe"}
SIZE = 64


def _frontend(**kw):
    return tfe.SiftFrontend(tfe.sift_config(SIZE), max_keypoints=32, dual_orientation=True,
                            device="cpu", **kw)


def _frames(batch):
    shape = (SIZE, SIZE) if batch is None else (batch, SIZE, SIZE)
    return torch.rand(shape, generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("profiler_on", [False, True])
def test_span_enters_a_range_only_while_a_profiler_runs(monkeypatch, profiler_on):
    entered = []

    def record_function(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: profiler_on)
    with tprof.span("sift.a"), tprof.stage_span("sift.b"), tprof.setup_span("sift.c"):
        pass
    assert entered == (["sift.a", "sift.b", "sift.c"] if profiler_on else [])


def test_forward_without_a_profiler_enters_no_range(monkeypatch):
    fe = _frontend()
    x = _frames(None)
    fe(x)
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", entered.append)
    fe(x)
    assert entered == []


@pytest.mark.parametrize("use_approx_topk", [False, True])
@pytest.mark.parametrize("batch", [None, 2])
def test_forward_under_a_profiler_nests_every_sub_span_in_its_stage(batch, use_approx_topk):
    fe = _frontend(use_approx_topk=use_approx_topk)
    x = _frames(batch)
    fe(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fe(x)
    spans = {}
    for e in prof.events():
        if e.name.startswith("sift."):
            assert e.name not in spans, f"{e.name} twice in one forward"
            spans[e.name] = (e.time_range.start, e.time_range.end)
    assert set(spans) == set(STAGES) | set(SUB_SPANS)
    for sub, stage in SUB_SPANS.items():
        assert spans[stage][0] <= spans[sub][0] <= spans[sub][1] <= spans[stage][1], sub
    assert spans["sift.pyramid"][1] <= spans["sift.detect"][0]
    assert spans["sift.detect"][1] <= spans["sift.describe"][0]


@pytest.mark.parametrize("batch", [None, 2])
def test_host_span_ring_holds_three_stage_spans_a_forward_in_order(batch):
    fe = _frontend()
    x = _frames(batch)
    t0 = time.perf_counter()
    fe(x)
    with profile(activities=[ProfilerActivity.CPU]):
        fe(x)
    fe(x)
    got = [s for s in tprof.host_spans() if s[1] >= t0]
    assert [name for name, _s, _e in got] == list(STAGES) * 3
    ends = [t for _name, s, e in got for t in (s, e)]
    assert ends == sorted(ends)


@pytest.mark.parametrize("record,read,capacity", [
    (tprof.stage_span, tprof.host_spans, tprof.HOST_SPAN_CAPACITY),
    (tprof.setup_span, tprof.setup_spans, tprof.SETUP_SPAN_CAPACITY),
])
def test_span_records_keep_their_newest_spans(record, read, capacity):
    for i in range(capacity + 10):
        with record(f"sift.test.{i}"):
            pass
    got = read()
    assert len(got) == capacity
    assert [name for name, _s, _e in got] == [f"sift.test.{i}" for i in range(10, capacity + 10)]


def test_setup_record_holds_one_construction_and_one_first_forward_an_instance():
    t0 = time.perf_counter()
    x = _frames(None)
    for _ in range(2):
        fe = _frontend()
        fe(x)
        fe(x)
    got = [s for s in tprof.setup_spans() if s[1] >= t0]
    assert [name for name, _s, _e in got] == ["sift.setup.frontend",
                                              "sift.setup.first_forward"] * 2
    assert all(s <= e for _name, s, e in got)
    # The first forward's stage spans lie inside its set-up span; none of
    # the set-up spans is in the stage ring.
    first = got[1]
    inside = [s for s in tprof.host_spans() if first[1] <= s[1] and s[2] <= first[2]]
    assert [name for name, _s, _e in inside] == list(STAGES)
    assert not any(name.startswith("sift.setup") for name, _s, _e in tprof.host_spans())
