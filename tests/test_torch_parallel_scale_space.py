"""The port's mesh, halo exchange and sharded scale space (``parallel/mesh.py``,
``halo.py``, ``scale_space.py``, ``dryrun.py``) on gloo ranks, against the
JAX package's sharded functions on the virtual 8-device CPU mesh and the
port's unsharded functions.

The port runs at world size 4 (meshes 1x4, 2x2, 4x1), 2 (1x2, 2x1), both
spawned once for the module (``tests/torch_dist_workers.py``), and 1 (1x1)
in this process. The JAX package runs the same functions on the same inputs
on meshes 1x4, 2x2 and 4x1 of its virtual devices; a port mesh of another
shape is held to the JAX 2x2 result (the function, not the mesh, sets it).
Sizes are the JAX tests': 64^2 row-sharded, 32^2 scale-sharded with S=2 and
S=5, 128^2 octave-sharded, 256^2 SIFT.

Tolerances:

* REFERENCE decompositions: bitwise equal to the port's unsharded plain
  version (the same elementwise expressions on each shard); within 1e-6 of
  each octave's largest magnitude of the JAX package's result (the two
  packages' f32 exp may differ by an ulp, and the JAX scale split subtracts
  Gaussian planes where the port subtracts windows: a rounding of the
  plane's scale, relative to an element it would be unbounded where two
  windows cross).
* SIFT pyramid, separable blur and blur bank: 1e-5 absolute on [0, 1]
  images (halo band products and dense Toeplitz products sum in another
  order); the sharded separable blur bitwise equal to the port's unsharded
  ``separable_blur`` (the same arithmetic on halo-extended rows).
"""

import ast
import inspect
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from sift_parallel_optimization_tpu.bench import roofline as jroofline
from sift_parallel_optimization_tpu.bench import scaling as jscaling
from sift_parallel_optimization_tpu.bench import suite as jsuite
from sift_parallel_optimization_tpu.config import PyramidConfig as JConfig
from sift_parallel_optimization_tpu.config import ScaleSpaceMode as JMode
from sift_parallel_optimization_tpu.core import pyramid_ref as jpr
from sift_parallel_optimization_tpu.parallel import mesh as jmesh
from sift_parallel_optimization_tpu.parallel import scale_space as jss
from sift_parallel_optimization_tpu.models.frontend import sift_config as jsift_config
from sift_parallel_optimization_tpu_torch.bench import scaling as tscaling
from sift_parallel_optimization_tpu_torch.bench import suite as tsuite
from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization_tpu_torch.core import pyramid_ref as tpr
from sift_parallel_optimization_tpu_torch.parallel import mesh as tmesh

REF_SCALE_RTOL = 1e-6
SIFT_ATOL = 1e-5
JAX_SHAPES = ((1, 4), (2, 2), (4, 1))
SHAPES = [(n, shape) for n in (1, 2, 4) for shape in W.MESH_SHAPES[n]]
IDS = [f"w{n}-{a}x{b}" for n, (a, b) in SHAPES]
SIFT_CFG = dict(length=256, S=2, max_octaves=3)
SCALING_SIZE, SCALING_COUNTS = 32, (1, 2, 4)


def _scaling(records: list, errors: list) -> None:
    """``bench_scaling`` on the CPU: gloo rank groups of 1, 2 and 4 (their
    times are real, the pyramid slope is stubbed)."""
    try:
        records += _run_bench(tscaling.bench_scaling, size=SCALING_SIZE, batch=4,
                              device_counts=SCALING_COUNTS, device="cpu", repeats=1)
    except BaseException as e:  # noqa: BLE001 - re-raised by the fixture
        errors.append(e)


def _run_bench(fn, **kw) -> list:
    records = []

    class Sink:
        def write(self, metric, value, unit, **extra):
            records.append({"metric": metric, "value": value, "unit": unit, **extra})

    fn(Sink(), **kw)
    return records


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port {world: {key: global array}}, JAX {shape: {key: array}}, the
    port's unsharded {key: array}, bench_scaling's records): worlds 2 and 4
    spawned together and the scaling sweep's rank groups started from a
    thread; world 1, the unsharded runs and the JAX runs (one thread a
    mesh: XLA compiles outside the GIL) in this process meanwhile. Slopes
    are names-only stubs for the whole fixture."""
    tmp = tmp_path_factory.mktemp("ranks")
    saved, tsuite.chained_slope_ms = tsuite.chained_slope_ms, W.names_only_slope
    scaling, errors = [], []
    thread = threading.Thread(target=_scaling, args=(scaling, errors))
    handle = W.start("scale_space", (2, 4), tmp)
    thread.start()
    try:
        with ThreadPoolExecutor(len(JAX_SHAPES)) as pool, W.one_thread():
            jax_runs = {shape: pool.submit(_jax_case, shape) for shape in JAX_SHAPES}
            with W.world1():
                port = {1: W.run_suite("scale_space", 1)}
            flat = _unsharded()
            jax_out = {shape: run.result() for shape, run in jax_runs.items()}
    finally:
        port.update(W.finish(handle))
        thread.join(W.JOIN_TIMEOUT_S * 3)
        tsuite.chained_slope_ms = saved
    assert not thread.is_alive(), "bench_scaling did not finish"
    if errors:
        raise errors[0]
    return port, jax_out, flat, scaling


@pytest.fixture(scope="module")
def port(results):
    return results[0]


@pytest.fixture(scope="module")
def jax_out(results):
    return results[1]


@pytest.fixture(scope="module")
def unsharded(results):
    return results[2]


def _jax_case(shape):
    mesh = jmesh.make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    out = {}
    row = jax.jit(lambda x: jss.sharded_reference_dog_pyramid(x, 2, mesh))(
        jnp.asarray(W.normal_image(64, 0)))
    out.update({f"row_pyr/{o}": np.asarray(a) for o, a in enumerate(row)})
    base = jnp.asarray(W.normal_image(32, 1))
    for S in (2, 5):
        out[f"scale_s{S}"] = np.asarray(jax.jit(jss.scale_sharded_reference_dog_octave(
            mesh, S, 32))(base))
    octp = jax.jit(lambda x: jss.octave_sharded_reference_dog_pyramid(x, 2, mesh))(
        jnp.asarray(W.normal_image(128, 2)))
    out.update({f"oct_pyr/{o}": np.asarray(a) for o, a in enumerate(octp)})
    cfg = JConfig(mode=JMode.SIFT, **SIFT_CFG)
    sift = jax.jit(lambda x: jss.sharded_sift_gaussian_pyramid(x, cfg, mesh))(
        jnp.asarray(W.unit_image(256, 3)))
    out.update({f"sift_pyr/{o}": np.asarray(a) for o, a in enumerate(sift)})
    img = jnp.asarray(W.unit_image(64, 4, width=48))
    out["sep_blur"] = np.asarray(jax.jit(jss.sharded_separable_blur(mesh))(
        img, jpr.gaussian_kernel_1d(1.6)))
    out["blur_bank"] = np.asarray(jax.jit(jss.sharded_blur_bank(mesh, 64, 48, [1.0, 2.5]))(img))
    return out


def _unsharded():
    t = torch.from_numpy
    out = {f"row_pyr/{o}": a.numpy() for o, a in enumerate(
        tpr.reference_dog_pyramid(t(W.normal_image(64, 0)), 2))}
    out.update({f"scale_s{S}": tpr.reference_dog_octave(t(W.normal_image(32, 1)), S).numpy()
                for S in (2, 5)})
    out.update({f"oct_pyr/{o}": a.numpy() for o, a in enumerate(
        tpr.reference_dog_pyramid(t(W.normal_image(128, 2)), 2))})
    cfg = PyramidConfig(mode=ScaleSpaceMode.SIFT, **SIFT_CFG)
    out.update({f"sift_pyr/{o}": a.numpy() for o, a in enumerate(
        tpr.sift_gaussian_pyramid(t(W.unit_image(256, 3)), cfg))})
    img = t(W.unit_image(64, 4, width=48))
    bank = [tpr._blur_stack(n, [1.0, 2.5], torch.float32, "cpu") for n in (64, 48)]
    out["blur_bank"] = tpr.blur_bank(img, *bank).numpy()
    out["sep_blur"] = tpr.separable_blur(img, tpr.gaussian_kernel_1d(1.6)).numpy()
    return out


def _case(port, n, shape, key):
    return port[n][f"{shape[0]}x{shape[1]}/{key}"]


REF_PREFIXES = ("row_pyr/", "scale_s", "oct_pyr/")


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
def test_reference_decompositions_bitwise_equal_unsharded(port, unsharded, n, shape):
    keys = [k for k in unsharded if k.startswith(REF_PREFIXES)]
    assert len(keys) == 7 + 2 + 8          # octaves of 64^2, two scale splits, octaves of 128^2
    for key in keys:
        np.testing.assert_array_equal(_case(port, n, shape, key), unsharded[key], err_msg=key)


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
def test_reference_decompositions_match_jax(port, jax_out, n, shape):
    want = jax_out[shape if shape in jax_out else (2, 2)]
    for key in [k for k in want if k.startswith(REF_PREFIXES)]:
        got, w = _case(port, n, shape, key), want[key]
        assert got.shape == w.shape, key
        np.testing.assert_allclose(got, w, rtol=0, atol=REF_SCALE_RTOL * np.abs(w).max(),
                                   err_msg=key)


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
def test_sift_sharded_pyramid_matches_unsharded_and_jax(port, jax_out, unsharded, n, shape):
    want = jax_out[shape if shape in jax_out else (2, 2)]
    for o in range(3):
        got = _case(port, n, shape, f"sift_pyr/{o}")
        np.testing.assert_allclose(got, unsharded[f"sift_pyr/{o}"], rtol=0, atol=SIFT_ATOL)
        np.testing.assert_allclose(got, want[f"sift_pyr/{o}"], rtol=0, atol=SIFT_ATOL)
    # Rows stay sharded while an octave splits evenly with room for the
    # 19-row halo (S=2's largest radius), then gather once.
    n_sp = shape[1]
    expect = ["S(1)" if (256 >> o) % (2 * n_sp) == 0 and (256 >> o) // n_sp >= 38 else "R"
              for o in range(3)]
    for o in range(1, 3):
        expect[o] = expect[o] if expect[o - 1] == "S(1)" else "R"
    assert list(_case(port, n, shape, "sift_placements")) == expect


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
def test_separable_blur_and_blur_bank_match_jax(port, jax_out, unsharded, n, shape):
    want = jax_out[shape if shape in jax_out else (2, 2)]
    for key in ("sep_blur", "blur_bank"):
        np.testing.assert_allclose(_case(port, n, shape, key), want[key], rtol=0,
                                   atol=SIFT_ATOL, err_msg=key)
    np.testing.assert_allclose(_case(port, n, shape, "blur_bank"), unsharded["blur_bank"],
                               rtol=0, atol=SIFT_ATOL)
    # The sharded blur runs the unsharded one's arithmetic on halo-extended
    # rows: bitwise equal.
    np.testing.assert_array_equal(_case(port, n, shape, "sep_blur"), unsharded["sep_blur"])


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
def test_halo_rows(port, n, shape):
    """Each shard's rows with 3 rows of each neighbour, the border shards'
    own edge row repeated: exactly the edge-padded image's windows."""
    img = np.arange(64 * 5, dtype=np.float32).reshape(64, 5)
    padded = np.pad(img, ((3, 3), (0, 0)), mode="edge")
    h = 64 // shape[1]
    want = np.concatenate([padded[i * h:i * h + h + 6] for i in range(shape[1])])
    np.testing.assert_array_equal(_case(port, n, shape, "halo"), want)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip(port, n):
    """One step of each path over the whole world; the octave sums against
    the unsharded pyramids on the same inputs."""
    got = {k.split("/")[-1]: v for k, v in port[n].items() if k.startswith("world/dryrun/")}
    assert str(got["mesh"]) == {1: "1x1", 2: "1x2", 4: "1x4"}[n]
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((64, 64), np.float32))
    ref = [float(o.sum()) for o in tpr.reference_dog_pyramid(img, 2, n_octaves=2)]
    np.testing.assert_allclose(got["reference"], ref, rtol=1e-6)
    cfg = PyramidConfig(length=64, S=2, mode=ScaleSpaceMode.SIFT, max_octaves=2)
    sift = [float(o.sum()) for o in tpr.sift_gaussian_pyramid(img, cfg)]
    np.testing.assert_allclose(got["sift"], sift, rtol=1e-5)
    batch = torch.from_numpy(rng.random((2, 64, 64), np.float32))
    dp = [float(sum(o.sum() for o in tpr.reference_dog_pyramid(f, 2, n_octaves=3)))
          for f in batch]
    np.testing.assert_allclose(got["data_parallel"], dp, rtol=1e-6)


def test_initialize_distributed_raises_on_a_failed_or_partial_init(monkeypatch, tmp_path):
    """No silent single-process fallback: a rendezvous that fails raises, and
    so does a partial rank environment."""
    import datetime

    import torch.distributed as dist

    assert not dist.is_initialized()
    store = dist.FileStore(str(tmp_path / "store"), 2)      # rank 1 never comes
    store.set_timeout(datetime.timedelta(seconds=1))
    with pytest.raises(RuntimeError, match="timeout"):
        tmesh.initialize_distributed(store=store, num_processes=2, process_id=0, device="cpu",
                                     timeout_s=1)
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="incomplete rank environment"):
        tmesh.initialize_distributed(device="cpu")
    with pytest.raises(ValueError, match="go together"):
        tmesh.initialize_distributed("127.0.0.1:1", device="cpu")


def test_backend_follows_the_device_and_meshes_are_checked():
    assert tmesh.backend_for("cuda") == "nccl" and tmesh.backend_for("cpu") == "gloo"
    with W.world1():
        mesh = tmesh.make_mesh(1, 1)
        assert mesh.device_type == "cpu" and tmesh.spatial_size(mesh) == tmesh.data_size(mesh) == 1
        with pytest.raises(ValueError, match="backend follows the device"):
            tmesh.all_reduce(torch.zeros(2, device="meta"), mesh, "data")
        with pytest.raises(ValueError, match="does not cover"):
            tmesh.make_mesh(2, 1)
        with pytest.raises(TypeError, match="DeviceMesh"):
            tmesh.check_mesh(object())
        assert tmesh.row_sharding(mesh, batched=True)[0].dim == 0


def _jax_written(fn) -> list:
    """(metric template, keyword names) of each ``writer.write`` call in a
    JAX bench function, read off its source; "{}" stands for a value."""
    out = []
    for node in ast.walk(ast.parse(inspect.getsource(fn))):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "write" and getattr(node.func.value, "id", "") == "writer"):
            name = node.args[0]
            template = ("".join(v.value if isinstance(v, ast.Constant) else "{}"
                                for v in name.values)
                        if isinstance(name, ast.JoinedStr) else name.value)
            out.append((template, {k.arg for k in node.keywords}))
    return out


BASE = {"metric", "value", "unit"}
PORT_ADDED = {"device", "backend"}


def test_bench_scaling_records_match_jax(results):
    """``cli bench --workloads scaling`` on the CPU: one frontend record a
    rank group (1, 2, 4 gloo ranks, each ran) and one pyramid record a
    count, with the JAX records' names and fields plus the documented
    ones, and the JAX roofline's link bytes and overlap model."""
    recs = results[3]
    written = _jax_written(jscaling.bench_scaling)
    front_keys = next(k for t, k in written if t.startswith("scaling_frontend") and "error" not in k)
    pyr_keys = next(k for t, k in written if t.startswith("scaling_pyramid"))
    assert [r["metric"] for r in recs] == (
        [f"scaling_frontend_{SCALING_SIZE}_n{n}" for n in SCALING_COUNTS]
        + [f"scaling_pyramid_ici_bytes_512_n{n}" for n in SCALING_COUNTS])
    jcfg = jsift_config(512)
    for r in recs[:len(SCALING_COUNTS)]:
        assert set(r) == BASE | front_keys | PORT_ADDED | {"dist_backend"}, r
        assert r["value"] > 0 and r["unit"] == "ms/frame" and r["dist_backend"] == "gloo"
        assert r["backend"] == "cpu" and r["ici_bytes_per_step"] == 0.0
    assert recs[0]["efficiency_vs_smallest"] == 1.0
    for n, r in zip(SCALING_COUNTS, recs[len(SCALING_COUNTS):]):
        assert set(r) == BASE | pyr_keys | PORT_ADDED | {"dist_backend", "single_chip_ms"}, r
        assert r["value"] == jroofline.sharded_pyramid_ici_bytes(jcfg, n)
        dep, n_ex = jroofline.sharded_pyramid_overlap_model(jcfg, n)
        assert r["dep_fraction"] == round(dep, 4) and r["n_exchanges"] == n_ex
        # No peaks on the CPU, and no measured exchange latency anywhere.
        assert r["projected_eff_no_overlap"] is None and r["projected_eff_overlap"] is None


@pytest.mark.parametrize("n", [1, 2, 4])
def test_matrix_mesh_sweep_records_match_jax(results, n):
    """``bench_matrix``'s mesh sweep at every factorization of the world,
    with the JAX record's name and fields plus the chained ones."""
    recs = [json.loads(r) for r in results[0][n]["world/mesh_sweep"]]
    template, keys = next((t, k) for t, k in _jax_written(jsuite.bench_matrix)
                          if t.startswith("matrix_mesh_shape"))
    assert [r["mesh"] for r in recs] == [f"{a}x{b}" for a, b in W.MESH_SHAPES[n]]
    for r in recs:
        assert r["metric"] == template.format(64)
        assert set(r) == BASE | keys | PORT_ADDED | {"chain", "capture_s", "peak_mib", "sm_mhz"}
        assert r["chain"] == [50, 400] and r["backend"] == "cpu"
