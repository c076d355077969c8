"""The port's SE(3) pose-graph optimization (``models/pose_graph``, the dense
solver) against the JAX package on the CPU: relative poses, residuals, the
forward-mode Jacobians (padded and near-identity edges included),
``optimize_pose_graph`` on tests/test_pose_graph.py's drifted circle, and the
solvers that are not ported yet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import pose_graph as jpg
from sift_parallel_optimization_tpu_torch.models import pose_graph as tpg

# Residuals and Jacobians: the same fp32 closed forms, rotations through
# one log map; 1e-5 absolute (entries are O(1)).
JAC_ATOL = 1e-5
# Poses after 25 GN iterations of a graph with drift: 1e-4.
POSE_ATOL = 1e-4


def _circle(rng, n=12, radius=2.0, padding=3, noise=0.0):
    """tests/test_pose_graph.py's circle: ground truth with tangent heading,
    an odometry chain + one loop edge from the truth, ``padding`` padded
    edges (i = j = 0, zero measurement, weight 0), and a drifted start."""
    rv, tv = [], []
    for k in range(n):
        ang = 2 * np.pi * k / n
        rv.append([0.0, ang, 0.0])
        R = np.asarray(jax.jit(jpg.rodrigues)(jnp.asarray(rv[-1], jnp.float32)))
        c = np.array([radius * np.cos(ang), 0.0, radius * np.sin(ang)], np.float32)
        tv.append(-R @ c)
    rv, tv = np.asarray(rv, np.float32), np.asarray(tv, np.float32)
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0)]
    rel = [jax.jit(jpg.relative_pose)(rv[i], tv[i], rv[j], tv[j]) for i, j in pairs]
    rr = np.stack([np.asarray(a) for a, _ in rel] + [np.zeros(3, np.float32)] * padding)
    rt = np.stack([np.asarray(b) for _, b in rel] + [np.zeros(3, np.float32)] * padding)
    if noise:
        rr[: len(pairs)] += rng.normal(size=(len(pairs), 3)).astype(np.float32) * noise
        rt[: len(pairs)] += rng.normal(size=(len(pairs), 3)).astype(np.float32) * noise
    edges = dict(i=np.array([i for i, _ in pairs] + [0] * padding, np.int32),
                 j=np.array([j for _, j in pairs] + [0] * padding, np.int32),
                 rel_rvec=rr.astype(np.float32), rel_tvec=rt.astype(np.float32),
                 weight=np.array([1.0] * (n - 1) + [4.0] + [0.0] * padding, np.float32))
    start_r = rv + np.vstack([np.zeros((1, 3)), rng.normal(size=(n - 1, 3)) * 0.05])
    start_t = tv + np.vstack([np.zeros((1, 3)), rng.normal(size=(n - 1, 3)) * 0.15])
    start = dict(rvecs=start_r.astype(np.float32), tvecs=start_t.astype(np.float32))
    return (rv, tv), edges, start


def _jax_graph(edges, poses):
    return (jpg.PoseGraphEdges(**{k: jnp.asarray(v) for k, v in edges.items()}),
            jpg.Poses(**{k: jnp.asarray(v) for k, v in poses.items()}))


def _torch_graph(edges, poses):
    return tpg.pose_graph_edges_from_numpy(edges, "cpu"), tpg.poses_from_numpy(poses, "cpu")


def test_relative_pose_matches_jax_batched(rng):
    r1, t1, r2, t2 = (rng.normal(size=(5, 3)).astype(np.float32) * s
                      for s in (0.4, 1.0, 0.4, 1.0))
    r2[0] = r1[0]                     # the identity relative rotation
    want = jax.jit(jax.vmap(jpg.relative_pose))(r1, t1, r2, t2)
    got = tpg.relative_pose(*map(torch.from_numpy, (r1, t1, r2, t2)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=JAC_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=JAC_ATOL)


def test_residuals_and_rms_match_jax(rng):
    _gt, edges, start = _circle(rng, noise=0.01)
    je, jp = _jax_graph(edges, start)
    te, tp = _torch_graph(edges, start)
    r = tpg.pgo_residuals(tp, te)
    np.testing.assert_allclose(r.numpy(), np.asarray(jax.jit(jpg.pgo_residuals)(jp, je)),
                               atol=JAC_ATOL)
    assert not r[-3:].any()                     # padded edges: weight 0
    np.testing.assert_allclose(float(tpg.pgo_rms(tp, te)), float(jpg.pgo_rms(jp, je)),
                               rtol=1e-5)


def test_edge_jacobians_match_jacfwd_on_padded_and_near_identity_edges(rng):
    """Padded edges sit at exactly the identity (i = j = 0, rel = 0) and
    differentiate rotation_log there; a near-identity edge (1e-7 rad) takes
    its small-angle branches. All Jacobians finite and equal to JAX's."""
    _gt, edges, start = _circle(rng, n=6, padding=2)
    edges["i"][2], edges["j"][2] = 3, 3            # i == j: R_rel = I exactly
    edges["rel_rvec"][2] = [1e-7, 0.0, 0.0]
    edges["rel_tvec"][2] = 0.0
    je, jp = _jax_graph(edges, start)
    te, tp = _torch_graph(edges, start)
    want = jax.jit(jpg._edge_jacobians)(jp, je)
    got = tpg._edge_jacobians(tp, te)
    for g, w, name in zip(got, want, ("ji", "jj", "r")):
        assert g.dtype == torch.float32
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=JAC_ATOL, err_msg=name)
    # Node-0 blocks are masked (gauge), padded rows are zero (weight 0).
    assert not got[0][0].any() and not got[1][-2:].any() and not got[2][-2:].any()


def test_optimize_pose_graph_matches_jax_and_corrects_drift(rng):
    (rv, tv), edges, start = _circle(rng)
    je, jp = _jax_graph(edges, start)
    te, tp = _torch_graph(edges, start)
    want = jax.jit(lambda p: jpg.optimize_pose_graph(p, je, n_iters=25, damping=1e-4))(jp)
    got = tpg.optimize_pose_graph(tp, te, n_iters=25, damping=1e-4)
    np.testing.assert_allclose(got.rvecs.numpy(), np.asarray(want.rvecs), atol=POSE_ATOL)
    np.testing.assert_allclose(got.tvecs.numpy(), np.asarray(want.tvecs), atol=POSE_ATOL)
    e0, e1 = float(tpg.pgo_rms(tp, te)), float(tpg.pgo_rms(got, te))
    assert e1 < 1e-3 < e0
    np.testing.assert_allclose(got.tvecs.numpy(), tv, atol=1e-3)
    # One step's blocks, the per-node sums (index_add_) against JAX's segment_sum.
    hd, cross, b = tpg.assemble_pgo_blocks(tp, te)
    jhd, jcross, jb = jax.jit(jpg.assemble_pgo_blocks)(jp, je)
    for g, w in ((hd, jhd), (cross, jcross), (b, jb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * float(np.abs(w).max()))


def test_unported_solvers_raise():
    poses = tpg.Poses(torch.zeros(4, 3), torch.zeros(4, 3))
    edges = tpg.PoseGraphEdges(torch.zeros(1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32), torch.zeros(1, 3),
                               torch.zeros(1, 3), torch.ones(1))
    for solver in ("cg", "chain"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tpg.optimize_pose_graph(poses, edges, solver=solver)
    big = tpg.Poses(torch.zeros(tpg.PGO_DENSE_LIMIT + 1, 3), torch.zeros(tpg.PGO_DENSE_LIMIT + 1, 3))
    for cap in (None, 32):
        with pytest.raises(NotImplementedError, match="not ported"):
            tpg.optimize_pose_graph(big, edges, offchain_cap=cap)
    assert tpg.resolve_pgo_solver(256) == jpg.resolve_pgo_solver(256) == "dense"
    assert tpg.PGO_DENSE_LIMIT == jpg.PGO_DENSE_LIMIT
    # The converters round-trip, dtypes kept.
    back = tpg.pose_graph_edges_to_numpy(edges)
    assert back["i"].dtype == np.int32 and back["weight"].dtype == np.float32
    again = tpg.pose_graph_edges_from_numpy(back, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(edges, again))
