"""The port's loop closure (``models/loop_closure``) against the JAX package
on the CPU, on a map whose blocks hold a seeded scene's landmarks and a
query view back at the start: the proposal with the JAX package's RANSAC
draws injected, writing its observations, the pose-graph edges, the
landmark re-anchoring and ``close_loops`` as a whole."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import loop_closure as jlc
from sift_parallel_optimization_tpu.models import matching as jm
from sift_parallel_optimization_tpu.models import pose_graph as jpg
from sift_parallel_optimization_tpu.models import sfm as jsfm
from sift_parallel_optimization_tpu.models.frontend import Features as JFeatures
from sift_parallel_optimization_tpu.models.geometry import Camera as JCamera
from sift_parallel_optimization_tpu.models.keypoints import Keypoints as JKeypoints
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models import loop_closure as tlc
from sift_parallel_optimization_tpu_torch.models import pose_graph as tpg
from sift_parallel_optimization_tpu_torch.models import sfm as tsfm
from sift_parallel_optimization_tpu_torch.models.geometry import Camera
from sift_parallel_optimization_tpu_torch.utils import synthetic

K_NP = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)
K_J, K_T = jnp.asarray(K_NP), torch.from_numpy(K_NP)
N_FRAMES, B, N_PTS, CAPACITY = 6, 64, 200, 256
# Poses: the PnP refinement of one inlier set in both packages, 1e-3
# (tests/test_torch_two_view.py's tolerance).
POSE_ATOL = 1e-3


def _jax_features(arrays):
    return JFeatures(JKeypoints(**{k: jnp.asarray(v) for k, v in arrays["keypoints"].items()}),
                     jnp.asarray(arrays["descriptors"]))


@pytest.fixture(scope="module")
def world():
    """A map of N_FRAMES camera slots whose first four point blocks hold the
    scene's landmarks (slot l = landmark l) at their true positions, the
    out-and-back poses (with drift added to the way back), and the features
    of frame 5, which is back at frame 0's pose."""
    rng = np.random.default_rng(0)
    pts, descs = synthetic.landmarks(rng, N_PTS)
    rv, tv = synthetic.out_and_back(N_FRAMES)
    drift = np.cumsum(rng.normal(size=(N_FRAMES, 3)) * 0.02, axis=0).astype(np.float32)
    drift[:3] = 0.0
    P = N_FRAMES * B
    m = jsfm.empty_map(N_FRAMES, B)
    m = m._replace(
        rvecs=jnp.asarray(rv), tvecs=jnp.asarray(tv + drift),
        cam_valid=jnp.ones(N_FRAMES, bool),
        points=jnp.asarray(np.pad(pts, ((0, P - N_PTS), (0, 0)))),
        pt_valid=jnp.asarray(np.arange(P) < N_PTS),
        pt_desc=jnp.asarray(np.pad(descs, ((0, P - N_PTS), (0, 0)))),
    )
    feats = synthetic.view_features(rng, pts, descs, rv[5], tv[5], K_NP, 400, 300, CAPACITY)
    return m, feats, (rv, tv)


_PROPOSALS: dict = {}


def _proposal(world, frame=5, min_gap=2, seed=3):
    """(JAX proposal, the port's, the port's map), computed once per
    (frame, min_gap, seed) for the tests that share it."""
    if (frame, min_gap, seed) not in _PROPOSALS:
        _PROPOSALS[frame, min_gap, seed] = _run_proposal(world, frame, min_gap, seed)
    return _PROPOSALS[frame, min_gap, seed]


def _run_proposal(world, frame, min_gap, seed):
    jmap, arrays, _ = world
    jf = _jax_features(arrays)
    key = jax.random.key(seed)
    want = jax.jit(lambda k, f, m: jlc.propose_loop_closure(k, f, m, frame, K_J, B,
                                                            min_gap=min_gap))(key, jf, jmap)
    tmap = tsfm.sfm_map_from_numpy(jmap, "cpu")
    draws = lambda valid, n, k: np.array(jax.jit(jm._sample_indices, static_argnums=(2, 3))(
        key, jnp.asarray(valid.numpy()), n, k))
    got = tlc.propose_loop_closure(None, tfe.features_from_numpy(arrays, "cpu"), tmap, frame,
                                   K_T, B, min_gap=min_gap, sample_idx=draws)
    return want, got, tmap


def test_propose_loop_closure_matches_jax_with_injected_draws(world):
    want, got, _ = _proposal(world)
    n = int(got.n_inliers)
    assert abs(n - int(want.n_inliers)) <= 1 and n >= 100
    np.testing.assert_allclose(got.rvec.numpy(), np.asarray(want.rvec), atol=POSE_ATOL)
    np.testing.assert_allclose(got.tvec.numpy(), np.asarray(want.tvec), atol=POSE_ATOL)
    # The loop pose is the true frame-5 pose (the map holds true landmarks).
    rv, tv = world[2]
    np.testing.assert_allclose(got.tvec.numpy(), tv[5], atol=0.02)
    v, jv = got.valid.numpy(), np.asarray(want.valid)
    assert abs(int(v.sum()) - int(jv.sum())) <= 1 and v.sum() == min(n, B)
    # The top-B inliers by similarity, ties to the lower slot: the same slots.
    same = (got.pt_idx.numpy() == np.asarray(want.pt_idx)) & v & jv
    assert same.sum() >= min(v.sum(), jv.sum()) - 2
    np.testing.assert_array_equal(got.uv.numpy()[same], np.asarray(want.uv)[same])
    # Too young a map: no landmark is old enough, nothing passes.
    young = _proposal(world, frame=1, min_gap=2)[1]
    assert int(young.n_inliers) == 0 and not bool(young.valid.any())


def test_write_loop_observations_equals_jax(world):
    want, _got, tmap = _proposal(world)
    prop = tlc.loop_proposal_from_numpy(want, "cpu")        # the same proposal on both sides
    jm_ = jax.jit(lambda m, p: jlc.write_loop_observations(m, p, 5, 1, B))(world[0], want)
    tm_ = tlc.write_loop_observations(tmap, prop, 5, 1, B)
    for f in ("cam_idx", "pt_idx", "uv", "valid"):
        np.testing.assert_array_equal(getattr(tm_.obs, f).numpy(),
                                      np.asarray(getattr(jm_.obs, f)), err_msg=f)
    start = 3 * N_FRAMES * B + B
    assert bool(tm_.obs.valid[start:start + B].any()) and not tmap.obs.valid.any()
    back = tlc.loop_proposal_to_numpy(prop)
    assert back["valid"].dtype == bool and back["pt_idx"].shape == (B,)


def _loops(world):
    """Two accepted loops: frame 5 (back at the start) and frame 4."""
    want5, _g, _m = _proposal(world)
    want4, _g, _m = _proposal(world, frame=4, seed=4)
    frames = [5, 4]
    jposes = [JCamera(want5.rvec, want5.tvec), JCamera(want4.rvec, want4.tvec)]
    tposes = [Camera(torch.from_numpy(np.asarray(c.rvec)), torch.from_numpy(np.asarray(c.tvec)))
              for c in jposes]
    return frames, jposes, tposes


@pytest.mark.parametrize("capacity", [None, 12])
def test_build_pose_graph_edges_matches_jax(world, capacity):
    frames, jposes, tposes = _loops(world)
    tmap = tsfm.sfm_map_from_numpy(world[0], "cpu")
    want = jlc.build_pose_graph_edges(world[0], N_FRAMES, frames, jposes, capacity=capacity)
    got = tlc.build_pose_graph_edges(tmap, N_FRAMES, frames, tposes, capacity=capacity)
    for f in ("i", "j", "weight"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in ("rel_rvec", "rel_tvec"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-5, err_msg=f)
    assert got.i.dtype == torch.int32 and got.weight.shape[0] == (capacity or N_FRAMES + 1)
    with pytest.raises(ValueError, match="edge capacity"):
        tlc.build_pose_graph_edges(tmap, N_FRAMES, frames, tposes, capacity=3)


def test_close_loops_and_pose_correction_match_jax(world):
    frames, jposes, tposes = _loops(world)
    tmap = tsfm.sfm_map_from_numpy(world[0], "cpu")
    want = jax.jit(lambda m: jlc.close_loops(m, N_FRAMES, frames, jposes, B))(world[0])
    got = tlc.close_loops(tmap, N_FRAMES, frames, tposes, B)
    np.testing.assert_allclose(got.rvecs.numpy(), np.asarray(want.rvecs), atol=POSE_ATOL)
    np.testing.assert_allclose(got.tvecs.numpy(), np.asarray(want.tvecs), atol=POSE_ATOL)
    v = tmap.pt_valid.numpy()
    np.testing.assert_allclose(got.points.numpy()[v], np.asarray(want.points)[v],
                               atol=POSE_ATOL * 12)       # depths up to 12
    # The graph's residual falls: the loop edges pull the drifted way back in.
    edges = tlc.build_pose_graph_edges(tmap, N_FRAMES, frames, tposes)
    before = float(tpg.pgo_rms(tpg.Poses(tmap.rvecs, tmap.tvecs), edges))
    assert float(tpg.pgo_rms(tpg.Poses(got.rvecs, got.tvecs), edges)) < 0.5 * before
    # Re-anchoring alone, against JAX's, with PGO's poses on both sides.
    new = jax.jit(lambda m, e: jpg.optimize_pose_graph(
        jpg.Poses(m.rvecs, m.tvecs), e, n_iters=12))(
        world[0], jlc.build_pose_graph_edges(world[0], N_FRAMES, frames, jposes))
    jw = jlc.apply_pose_correction(world[0], new, B)
    tw = tlc.apply_pose_correction(tmap, tpg.Poses(torch.from_numpy(np.asarray(new.rvecs)),
                                                   torch.from_numpy(np.asarray(new.tvecs))), B)
    np.testing.assert_allclose(tw.points.numpy(), np.asarray(jw.points), atol=1e-4)
    # A mesh must be a (data, spatial) DeviceMesh (parallel/mesh.make_mesh;
    # the distributed PGO itself: tests/test_torch_parallel_data.py).
    with pytest.raises(TypeError, match="DeviceMesh"):
        tlc.close_loops(tmap, N_FRAMES, frames, tposes, B, mesh=object())
