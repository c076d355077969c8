"""The port's benchmark matrix (``bench/suite.py``) and ``cli bench`` on the
CPU, at tiny sizes, against the JAX package's suite.

Both suites run with ``chained_slope_ms`` replaced by a stub that runs the
step once and returns 1.0 (the port's tracking slope the same way), so the
records' NAMES and FIELDS are compared, not times. The JAX frame-batch
matrix would compile its frontend eight times on the CPU (~30 s): its stub
does not run the step. The JAX stream and tracking workloads need the JAX
package's host library (it races with itself on a fresh tree under xdist)
and compile their scan chains for a minute: their records are read off the
JAX suite's source instead.

The documented differences (``bench/suite.py``'s docstring): every port
record adds ``device`` and ``backend``; a chained record adds ``chain``,
``capture_s``, ``peak_mib`` and ``sm_mhz``; a pyramid record ``device_ms``; a
tracking record ``device_ms`` and ``device_top``; a stream
record ``chain`` (None: a wall, not a chain); the frame-batch records
``jax_path``; the pyramid variants ``cuda``/``plain`` stand for
``pallas``/``jnp``, the frame-batch path ``per_frame`` for ``vmap``; the
matrix has no Pallas ``tile_rows`` records (its ``blur_precision`` records
are JAX's, field for field), and its
mesh-shape records are the port's world's factorizations (here 1x1; at 2
and 4 ranks: tests/test_torch_parallel_scale_space.py, with the scaling
workload)."""

import ast
import collections
import inspect
import json
import math
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from sift_parallel_optimization_tpu.bench import suite as jsuite
from sift_parallel_optimization_tpu.utils.profiling import MetricsWriter as JaxWriter
from sift_parallel_optimization_tpu_torch import cli as tcli
from sift_parallel_optimization_tpu_torch.bench import suite as tsuite
from sift_parallel_optimization_tpu_torch.utils.profiling import MetricsWriter

ADDED = {"device", "backend"}
CHAINED = ADDED | {"chain", "capture_s", "peak_mib", "sm_mhz"}
EXTRA = {"pyramid": CHAINED | {"device_ms"}, "frontend": CHAINED, "stages": CHAINED,
         "matching": CHAINED, "ba": CHAINED, "matrix": CHAINED,
         "tracking": CHAINED | {"device_ms", "device_top"},
         "stream": ADDED | {"chain"}}
VALUE_MAP = {("variant", "jnp"): "plain", ("variant", "pallas"): "cuda",
             ("path", "vmap"): "per_frame"}
# Fields that are configuration, not measurement: equal in both suites.
CONFIG_FIELDS = ("variant", "S", "max_keypoints", "obs", "solver", "window", "pts_per_frame",
                 "ba_iters", "archive_slots", "frames", "dual_orientation", "batch", "path",
                 "dtype", "blur_precision")
TINY = {
    "pyramid": dict(sizes=(64,)),
    "frontend": dict(sizes=(64,), max_keypoints=32),
    "stages": dict(size=64, max_keypoints=32),
    "matching": dict(k=32),
    "ba": dict(n_cams=3, n_pts=10, n_iters=2),
    "matrix": dict(size=64),
    "stream": dict(size=64, frames=2, max_keypoints=32),
    "tracking": dict(size=64, window=3, pts_per_frame=16, ba_iters=1),
}


class _Buffer:
    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)

    def flush(self):
        pass


def _records(writer_cls, fn, **kw):
    buf = _Buffer()
    w = writer_cls.__new__(writer_cls)
    w._fh, w._owned = buf, False
    fn(w, **kw)
    return [json.loads(line) for line in "".join(buf.lines).splitlines()]


def _port_stub(step, example, info=None, chain_lo=50, chain_hi=400, **kw):
    float(step(example))
    if info is not None:
        info["chain"] = [chain_lo, chain_hi]
    return 1.0


def _port_replay_stub(runner, i, do_loop, generator, **kw):
    runner.run(i, True, do_loop, generator=generator)
    return 1.0, {"chain": [4, 16], "capture_s": None, "peak_mib": None, "sm_mhz": None,
                 "device_ms": None, "device_top": None}


def _jax_stub(step, example, **kw):
    float(jnp.sum(jax.jit(step)(example)))
    return 1.0


def _jax_names_only_stub(step, example, **kw):
    return 1.0


@pytest.fixture
def stubs(monkeypatch):
    monkeypatch.setattr(tsuite, "chained_slope_ms", _port_stub)
    monkeypatch.setattr(tsuite, "_replay_slope", _port_replay_stub)
    monkeypatch.setattr(jsuite, "chained_slope_ms", _jax_stub)
    return monkeypatch


def _jax_written(fn_name):
    """(metric template, keyword names) of each ``writer.write`` call in a
    JAX suite function, read off its source; ``{}`` stands for a formatted
    value."""
    tree = ast.parse(inspect.getsource(getattr(jsuite, fn_name)))
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "write" and getattr(node.func.value, "id", "") == "writer"):
            name = node.args[0]
            template = ("".join(v.value if isinstance(v, ast.Constant) else "{}"
                                for v in name.values)
                        if isinstance(name, ast.JoinedStr) else name.value)
            out.append((template, {k.arg for k in node.keywords}))
    return out


def _check_port_records(workload, port):
    for r in port:
        assert r["device"] == "cpu" and r["backend"] == "cpu"
        assert isinstance(r["value"], (int, float)) and math.isfinite(r["value"])
        for key in ("sol_pct", "floor_ms", "bound", "capture_s", "peak_mib", "device_ms",
                    "sm_mhz", "device_top"):
            assert r.get(key) is None, (key, r)   # no device peaks, no card numbers on the CPU


@pytest.mark.parametrize("workload", ["pyramid", "frontend", "stages", "matching", "ba", "matrix"])
def test_records_equal_jax(stubs, workload):
    """Record for record: the same metric names in the same order, the same
    fields plus the documented ones, the same configuration values."""
    fn = f"bench_{workload}"
    if workload == "matrix":
        stubs.setattr(jsuite, "chained_slope_ms", _jax_names_only_stub)
    jax_recs = _records(JaxWriter, getattr(jsuite, fn), **TINY[workload])
    port = _records(MetricsWriter, getattr(tsuite, fn), device="cpu", **TINY[workload])
    if workload == "matrix":
        jax_mesh = [r for r in jax_recs if r["metric"].startswith("matrix_mesh_shape")]
        jax_recs = [r for r in jax_recs
                    if not r["metric"].startswith(("matrix_pallas_tile", "matrix_mesh_shape"))]
        port_mesh = [r for r in port if r["metric"].startswith("matrix_mesh_shape")]
        port = [r for r in port if not r["metric"].startswith("matrix_mesh_shape")]
        # One process: the world is 1, and the sweep's one shape is 1x1.
        assert [r["mesh"] for r in port_mesh] == ["1x1"]
        assert port_mesh[0]["metric"] == jax_mesh[0]["metric"]
        assert set(port_mesh[0]) == set(jax_mesh[0]) | EXTRA["matrix"]
        assert not torch.distributed.is_initialized()     # the sweep's own group is gone
    assert [r["metric"] for r in port] == [r["metric"] for r in jax_recs]
    for p, j in zip(port, jax_recs):
        want = set(j) | EXTRA[workload] | ({"jax_path"} if "path" in j else set())
        assert set(p) == want, (p["metric"], set(p) ^ want)
        assert p["unit"] == j["unit"]
        for key in CONFIG_FIELDS:
            if key in j:
                assert p[key] == VALUE_MAP.get((key, j[key]), j[key]), (p["metric"], key)
    if workload == "matrix":
        assert {r.get("jax_path") for r in port} == {None, "vmap", "batched"}
    _check_port_records(workload, port)


@pytest.mark.parametrize("workload", ["stream", "tracking"])
def test_records_equal_jax_source(stubs, workload):
    """The stream and the two tracking records against the ``writer.write``
    calls of the JAX suite's source."""
    written = _jax_written(f"bench_{workload}")
    port = _records(MetricsWriter, getattr(tsuite, f"bench_{workload}"), device="cpu",
                    **TINY[workload])
    size = TINY[workload]["size"]
    assert [r["metric"] for r in port] == [t.format(size) for t, _keys in written]
    for r, (_t, keys) in zip(port, written):
        assert set(r) == {"metric", "value", "unit"} | keys | EXTRA[workload]
        assert r["value"] > 0
    if workload == "tracking":
        assert [r["window"] for r in port] == [3, 3] and port[1]["archive_slots"] == 64 * 16
    else:
        assert port[0]["dual_orientation"] is True and port[0]["frames"] == 2
    _check_port_records(workload, port)


def test_run_suite_sizes_and_workloads(stubs):
    """``size`` sets every sized workload's one side; tracking then runs at
    that size alone. An unknown workload raises; ``scaling`` is one of the
    workloads (its records: tests/test_torch_parallel_scale_space.py)."""
    recs = _records(MetricsWriter, tsuite.run_suite, workloads=("pyramid", "frontend"), size=48,
                    max_keypoints=16, device="cpu")
    assert [r["metric"] for r in recs] == ["pyramid_dog_ms_per_frame_48", "frontend_ms_per_frame_48",
                                          "frontend_dual_ms_per_frame_48"]
    with pytest.raises(ValueError, match="unknown workloads"):
        _records(MetricsWriter, tsuite.run_suite, workloads=("pyramids",), device="cpu")
    assert tsuite.WORKLOADS[-1] == "scaling"


def test_cli_bench_writes_jsonl(tmp_path):
    """As tests/test_cli.py does for the JAX CLI: matching on the CPU (real
    chained slopes, CPU times)."""
    out = tmp_path / "m.jsonl"
    assert tcli.main(["bench", "--workloads", "matching", "--device", "cpu",
                      "--out", str(out)]) == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["metric"] for r in lines] == ["match_ms_512x512", "ransac_homography_ms_512"]
    assert all(r["value"] >= 0 and r["backend"] == "cpu" and r["chain"] == [30, 200]
               for r in lines)


def test_cli_bench_refuses_scaling_and_a_missing_card(monkeypatch, tmp_path):
    """Without a card, the default device refuses every workload, scaling's
    rank groups included: nothing falls back to gloo on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["bench", "--workloads", "scaling", "--out", str(tmp_path / "s.jsonl")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["bench", "--workloads", "matching", "--out", str(tmp_path / "x.jsonl")])


def test_chained_slope_ms_reports_the_chain_it_ran():
    """``info`` receives the chain lengths after the pilot's stretch; the CPU
    has no capture or device memory to report."""
    from sift_parallel_optimization_tpu_torch.utils.profiling import chained_slope_ms

    x = torch.rand(64, 64, generator=torch.Generator().manual_seed(0))
    info = {}
    ms = chained_slope_ms(lambda c: c.sum(), x, chain_lo=2, chain_hi=4, repeats=1, info=info)
    assert ms >= 0 and info == {"chain": [2, 4]}
    info = {}
    chained_slope_ms(lambda c: (c @ c).sum(), x, chain_lo=2, chain_hi=4, repeats=1,
                     min_hi_total_ms=5.0, info=info)
    lo, hi = info["chain"]
    assert hi == 2 * lo and hi >= 4


_Carry = collections.namedtuple("_Carry", "x inner")
_Inner = collections.namedtuple("_Inner", "y none")


class _DrawingRunner:
    """A stand-in for ``SteadyStepRunner``: each frame draws from the
    generator and adds the draw to its carry, and notes the carry and the
    draw it started from."""

    def __init__(self):
        self.u = torch.zeros(1)
        self.carry = _Carry(torch.zeros(3), _Inner(torch.ones(2), None))
        self.seen = []

    def run(self, i, do_ba, do_loop, generator=None):
        draw = torch.rand(3, generator=generator)
        self.seen.append((float(self.carry[0].sum()), draw))
        self.carry[0].add_(draw)
        self.carry[1][0].mul_(2.0)


def test_replay_slope_restores_the_carry_and_the_draws():
    """Every timed run starts from the carry AND the generator state the
    measurement began with, so every run replays the same frames and draws;
    the carry is put back at the end, and the CPU has no card fields."""
    runner = _DrawingRunner()
    gen = torch.Generator().manual_seed(0)
    ms, fields = tsuite._replay_slope(runner, 2, False, gen, lo=1, hi=2, repeats=2,
                                      min_hi_total_ms=0.0)
    assert ms > 0 and fields["chain"] == [1, 2]
    assert {k: fields[k] for k in ("capture_s", "peak_mib", "sm_mhz", "device_ms",
                                   "device_top")} == dict.fromkeys(
        ("capture_s", "peak_mib", "sm_mhz", "device_ms", "device_top"))
    # Warm-up, capture, then each timed run (1 or 2 frames) from the start.
    first = [(c, d) for c, d in runner.seen if c == 0.0]
    assert len(first) >= 2 + 2 * 2
    assert all(torch.equal(d, first[0][1]) for _c, d in first)
    assert float(runner.carry[0].sum()) == 0.0 and torch.equal(runner.carry[1][0], torch.ones(2))


def test_slope_ms_runs_before_every_timed_run(monkeypatch):
    """``slope_ms``: ``before`` precedes every run (warm and timed), the
    pilot stretches both lengths, and the slope is never below 0. A fake
    clock, advanced 0.1 ms a step by the runs, times them, so the host's
    load cannot move what is asserted."""
    from sift_parallel_optimization_tpu_torch.utils import profiling

    now = [0.0]
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter=lambda: now[0]))
    log = []
    run_of = lambda n: (lambda: log.append(("run", n)))
    ms, chain = profiling.slope_ms(run_of, 2, 4, repeats=2,
                                   before=lambda: log.append("before"))
    assert ms == 0 and chain == [2, 4]
    assert log[0::2] == ["before"] * (len(log) // 2)
    assert [e[1] for e in log[1::2]] == [2, 4, 4, 4, 2, 2]

    def steps(n):
        def run():
            now[0] += 1e-4 * n
        return run

    ms, chain = profiling.slope_ms(steps, 1, 2, repeats=1, min_hi_total_ms=5.0)
    assert chain[1] == 2 * chain[0] and chain[1] > 2
    assert ms == pytest.approx(0.1)
