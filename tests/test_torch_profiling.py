"""The port's wall-clock timers, trace context and metrics sink
(``utils/profiling``) on the CPU, against the JAX package's where both
produce the same thing. The card-only timers (``cuda_time_ms``,
``profile_device``) are tested in test_torch_package.py (they refuse the
CPU) and on the card."""

import json

import torch

from sift_parallel_optimization_tpu.utils import profiling as jprof
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


def test_steady_state_ms_orders_a_heavier_call_above_a_lighter():
    x = torch.rand(192, 192, generator=torch.Generator().manual_seed(0))
    light = tprof.steady_state_ms(lambda: _light(x), min_seconds=0.05, warmup=1)
    heavy = tprof.steady_state_ms(lambda: _heavy(x), min_seconds=0.05, warmup=1)
    assert 0 < light < heavy < 1e3


def test_chained_slope_ms_orders_a_heavier_step_above_a_lighter():
    x = torch.rand(192, 192, generator=torch.Generator().manual_seed(0))
    kw = dict(chain_lo=4, chain_hi=16, repeats=2, median_of=3)
    light = tprof.chained_slope_ms(_light, x, **kw)
    heavy = tprof.chained_slope_ms(_heavy, x, **kw)
    assert 0 <= light < heavy < 1e3
    # A pilot run stretches both chains until the long one takes 20 ms.
    assert tprof.chained_slope_ms(_heavy, x, chain_lo=1, chain_hi=2, repeats=1,
                                  min_hi_total_ms=20.0) > 0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    x = torch.rand(64, 64)
    with tprof.profiler_trace(str(tmp_path / "tr")) as path:
        (x @ x).sum()
    trace = json.loads(open(path).read())
    assert path.startswith(str(tmp_path / "tr")) and path.endswith(".pt.trace.json")
    assert any(e.get("name", "").startswith("aten::mm") for e in trace["traceEvents"])
    with tprof.profiler_trace(None) as nothing:
        assert nothing is None
