"""The port's distributed bundle adjustment (``parallel/ba.py``, dense and
implicit-Schur CG) and distributed PGO (``parallel/pose_graph.py``) on gloo
ranks, against the JAX package's on the virtual 8-device CPU mesh and the
port's single-device solvers.

The port runs at world sizes 4 (1x4, 2x2, 4x1), 2 (1x2, 2x1), spawned once
for the module (``tests/torch_dist_workers.py``), and 1 (1x1) in this
process; the JAX package on its 4x1 mesh (observations and edges over four
devices). The BA scene is the JAX CG padding test's: 5 cameras and 37
points (37 splits over no axis size but 1, so the landmark blocks are
padded), 6 Gauss-Newton steps; the pose graph tests/test_torch_pose_graph.py's
12-node circle with 3 inert padding edges, 25 steps.

Tolerances are those of tests/test_torch_ba.py and
tests/test_torch_pose_graph.py against JAX: BA states within 1e-4 of each
field's largest magnitude (STATE_RTOL), poses within 1e-4 (POSE_ATOL).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from sift_parallel_optimization_tpu.models import ba as jba
from sift_parallel_optimization_tpu.models import pose_graph as jpg
from sift_parallel_optimization_tpu.parallel import ba as jpba
from sift_parallel_optimization_tpu.parallel import mesh as jmesh
from sift_parallel_optimization_tpu.parallel import pose_graph as jppg
from sift_parallel_optimization_tpu_torch.models import ba as tba
from sift_parallel_optimization_tpu_torch.models import pose_graph as tpg
from sift_parallel_optimization_tpu_torch.parallel import ba as pba
from sift_parallel_optimization_tpu_torch.parallel import pose_graph as ppg

STATE_RTOL = 1e-4
POSE_ATOL = 1e-4
SHAPES = [(n, shape) for n in (1, 2, 4) for shape in W.MESH_SHAPES[n]]
IDS = [f"w{n}-{a}x{b}" for n, (a, b) in SHAPES]
BA_KW = dict(n_iters=6, damping=1e-4)


def _jax_ba(solver):
    mesh = jmesh.make_mesh(4, 1, devices=jax.devices()[:4])
    start, obs, k = W.ba_scene(5, 37, 0)
    st, ob = jba.BAState(*map(jnp.asarray, start)), jba.Observations(*map(jnp.asarray, obs))
    got = jax.jit(lambda s, o: jpba.distributed_bundle_adjust(
        s, o, jnp.asarray(k), mesh, solver=solver, **BA_KW))(st, ob)
    return {f"ba_{solver}/{f}": np.asarray(v) for f, v in got._asdict().items()}


def _jax_pgo():
    mesh = jmesh.make_mesh(4, 1, devices=jax.devices()[:4])
    edges, p0 = W.circle_graph(0)
    got = jax.jit(lambda p, e: jppg.distributed_pgo(p, e, mesh, n_iters=25, damping=1e-4))(
        jpg.Poses(**{k: jnp.asarray(v) for k, v in p0.items()}),
        jpg.PoseGraphEdges(**{k: jnp.asarray(v) for k, v in edges.items()}))
    return {"pgo/rvecs": np.asarray(got.rvecs), "pgo/tvecs": np.asarray(got.tvecs)}


def _single_device():
    start, obs, k = W.ba_scene(5, 37, 0)
    st = tba.BAState(*map(torch.from_numpy, start))
    ob = tba.Observations(*map(torch.from_numpy, obs))
    out = {}
    for solver in ("dense", "cg"):
        got = tba.bundle_adjust(st, ob, torch.from_numpy(k), solver=solver, **BA_KW)
        out.update({f"ba_{solver}/{f}": v.numpy() for f, v in got._asdict().items()})
    edges, p0 = W.circle_graph(0)
    got = tpg.optimize_pose_graph(tpg.poses_from_numpy(p0, "cpu"),
                                  tpg.pose_graph_edges_from_numpy(edges, "cpu"), n_iters=25,
                                  damping=1e-4, solver="dense")
    out["pgo/rvecs"], out["pgo/tvecs"] = got.rvecs.numpy(), got.tvecs.numpy()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port {world: {key: array}}, JAX {key: array}, single device {key:
    array}); worlds 2 and 4 spawned while this process runs the rest (the
    JAX runs in threads: XLA compiles outside the GIL)."""
    tmp = tmp_path_factory.mktemp("ranks")
    handle = W.start("ba", (2, 4), tmp)
    try:
        with ThreadPoolExecutor(3) as pool, W.one_thread():
            jax_runs = [pool.submit(_jax_ba, "dense"), pool.submit(_jax_ba, "cg"),
                        pool.submit(_jax_pgo)]
            with W.world1():
                port = {1: W.run_suite("ba", 1)}
            single = _single_device()
            jax_out = {k: v for run in jax_runs for k, v in run.result().items()}
    finally:
        port.update(W.finish(handle))
    return port, jax_out, single


def _get(results, n, shape, key):
    return results[0][n][f"{shape[0]}x{shape[1]}/{key}"]


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_distributed_bundle_adjust_matches_jax_and_single_device(results, n, shape, solver):
    for want in (results[1], results[2]):
        for f in tba.BAState._fields:
            w = want[f"ba_{solver}/{f}"]
            np.testing.assert_allclose(_get(results, n, shape, f"ba_{solver}/{f}"), w, rtol=0,
                                       atol=STATE_RTOL * np.abs(w).max(), err_msg=f)
    # Converged: the exact observations reproject within a hundredth of a pixel.
    start, obs, k = W.ba_scene(5, 37, 0)
    state = tba.BAState(*[torch.from_numpy(_get(results, n, shape, f"ba_{solver}/{f}"))
                          for f in tba.BAState._fields])
    rms = float(tba.rms_error(state, tba.Observations(*map(torch.from_numpy, obs)),
                              torch.from_numpy(k)))
    assert rms < 0.05


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
def test_distributed_pgo_matches_jax_and_single_device(results, n, shape):
    for want in (results[1], results[2]):
        for f in ("rvecs", "tvecs"):
            np.testing.assert_allclose(_get(results, n, shape, f"pgo/{f}"), want[f"pgo/{f}"],
                                       rtol=0, atol=POSE_ATOL, err_msg=f)


def test_padding_is_inert():
    """pad_observations / pad_edges reach a multiple with invalid slots and
    zero-weight edges; a list that does not split is refused."""
    _start, obs, _k = W.ba_scene(5, 37, 0)
    ob = tba.Observations(*map(torch.from_numpy, obs))
    padded = pba.pad_observations(ob, 8)
    assert padded.cam_idx.shape[0] == 192 and int(padded.valid.sum()) == 185
    assert pba.pad_observations(padded, 8) is padded
    edges, _p0 = W.circle_graph(0)
    e = ppg.pad_edges(tpg.pose_graph_edges_from_numpy(edges, "cpu"), 4)
    assert e.i.shape[0] == 16 and float(e.weight[15:].abs().sum()) == 0.0
    with W.world1():
        from sift_parallel_optimization_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(1, 1)
        assert pba.local_observations(padded, mesh).cam_idx.shape[0] == 192
        with pytest.raises(ValueError, match="solver"):
            pba.distributed_bundle_adjust(tba.BAState(*map(torch.from_numpy, _start)), ob,
                                          torch.from_numpy(_k), mesh, solver="lm")
