"""The port's Sim(3) pose graph (``models/pose_graph_sim3``) against the JAX
package on the CPU: residuals and forward-mode Jacobians (metric and padded
edges), the measured scale ratio, each solver (dense, CG, chain + Woodbury)
against JAX's and against each other, and tests/test_pose_graph_sim3.py's
oracles: scale drift that SE(3) cannot fix, a consistent chain left alone,
the auto dispatch, and the 1,000-node scale-ramp chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import pose_graph as jpg
from sift_parallel_optimization_tpu.models import pose_graph_sim3 as jps
from sift_parallel_optimization_tpu_torch.models import pose_graph as tpg
from sift_parallel_optimization_tpu_torch.models import pose_graph_sim3 as tps
from sift_parallel_optimization_tpu_torch.utils import trajectory as ttraj

# Residuals and Jacobians: the same fp32 closed forms; 1e-5 absolute.
JAC_ATOL = 1e-5
# Solver outputs against JAX's same solver: both are LU-pivoted f32 solves of
# the same damped (1e-4) system, which differ by f32 round-off relative to
# the poses (up to 7 here): rtol 5e-4 (measured 1e-4) with atol 1e-4 after a
# GN step, 2e-4 after several.
STEP_RTOL, STEP_ATOL, RUN_ATOL = 5e-4, 1e-4, 2e-4

_rel = jax.jit(jax.vmap(jpg.relative_pose))
_rod, _log = jax.jit(jpg.rodrigues), jax.jit(jpg.rotation_log)


def _integrate(gt_r, gt_t, per_edge_scale):
    """Odometry integrated from the true relative steps, each step's length
    scaled by a growing factor (the monocular drift model)."""
    rr, rt = (np.asarray(a) for a in _rel(gt_r[:-1], gt_t[:-1], gt_r[1:], gt_t[1:]))
    est_r, est_t, s = [gt_r[0]], [gt_t[0]], 1.0
    for k in range(len(rr)):
        s *= per_edge_scale
        R_rel = np.asarray(_rod(rr[k]))
        est_t.append((R_rel @ est_t[-1] + s * rt[k]).astype(np.float32))
        est_r.append(np.asarray(_log(R_rel @ np.asarray(_rod(est_r[-1])))))
    return np.stack(est_r).astype(np.float32), np.stack(est_t).astype(np.float32)


def _edges(est_r, est_t, gt_r, gt_t, loop_i, loop_j, loop_w, pad=0):
    """The drifted chain (measured from the estimates) + METRIC loop edges
    carrying the TRUE relative pose (what an archive PnP provides), as numpy
    Sim3Edges fields, with ``pad`` padded slots (weight 0)."""
    n = len(est_r)
    cr, ct = (np.asarray(a) for a in _rel(est_r[:-1], est_t[:-1], est_r[1:], est_t[1:]))
    lr, lt = (np.asarray(a) for a in _rel(gt_r[loop_i], gt_t[loop_i], gt_r[loop_j],
                                          gt_t[loop_j]))
    z = lambda *s: np.zeros(s, np.float32)
    L = len(loop_i)
    return dict(
        i=np.concatenate([np.arange(n - 1), loop_i, np.zeros(pad)]).astype(np.int32),
        j=np.concatenate([np.arange(1, n), loop_j, np.ones(pad)]).astype(np.int32),
        rel_rvec=np.concatenate([cr, lr, z(pad, 3)]).astype(np.float32),
        rel_tvec=np.concatenate([ct, lt, z(pad, 3)]).astype(np.float32),
        rel_log_s=z(n - 1 + L + pad),
        weight=np.concatenate([np.ones(n - 1), np.full(L, loop_w), z(pad)]).astype(np.float32),
        metric=np.concatenate([z(n - 1), np.ones(L), z(pad)]).astype(np.float32),
    )


def _drifted_chain(n=12, per_edge_scale=1.06, seed=0, pad=0):
    """tests/test_pose_graph_sim3.py's chain: poses along a line whose
    odometry step lengths grow by ``per_edge_scale``, one metric loop 0 ->
    n-1 of weight 8."""
    rng = np.random.default_rng(seed)
    gt_r = (0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    gt_t = np.stack([np.linspace(0, 4, n), 0.2 * np.sin(np.linspace(0, 3, n)),
                     np.zeros(n)], 1).astype(np.float32)
    est_r, est_t = _integrate(gt_r, gt_t, per_edge_scale)
    edges = _edges(est_r, est_t, gt_r, gt_t, np.array([0]), np.array([n - 1]), 8.0, pad)
    return (gt_r, gt_t), (est_r, est_t), edges


def _both(edges, rvecs, tvecs, log_s=None):
    """(JAX, port) edges and poses from the same numpy arrays."""
    log_s = np.zeros(len(rvecs), np.float32) if log_s is None else log_s
    poses = dict(rvecs=rvecs, tvecs=tvecs, log_s=log_s)
    return ((jps.Sim3Edges(**{k: jnp.asarray(v) for k, v in edges.items()}),
             jps.Sim3Poses(**{k: jnp.asarray(v) for k, v in poses.items()})),
            (tps.sim3_edges_from_numpy(edges, "cpu"), tps.sim3_poses_from_numpy(poses, "cpu")))


def _ate(rvecs, tvecs, gt_r, gt_t):
    """ATE WITHOUT scale alignment: the scale drift must be corrected, not
    hidden by the evaluation's alignment."""
    gt = ttraj.camera_centers(torch.from_numpy(gt_r), torch.from_numpy(gt_t))
    return float(ttraj.ate_rmse(ttraj.camera_centers(rvecs, tvecs), gt, with_scale=False))


def test_residuals_jacobians_and_scale_ratio_match_jax():
    """Metric and chain rows, padded slots (i = 0, j = 1, weight 0) and a
    non-zero scale state: residuals, rms and the jacfwd Jacobians equal
    JAX's; node-0 blocks masked; every output fp32."""
    _gt, (er, et), edges = _drifted_chain(n=8, pad=3)
    log_s = np.linspace(0.0, 0.3, 8).astype(np.float32)
    (je, jp), (te, tp) = _both(edges, er, et, log_s)
    r = tps.sim3_residuals(tp, te)
    np.testing.assert_allclose(r.numpy(), np.asarray(jax.jit(jps.sim3_residuals)(jp, je)),
                               atol=JAC_ATOL)
    assert not r[-3:].any()
    np.testing.assert_allclose(float(tps.sim3_rms(tp, te)), float(jps.sim3_rms(jp, je)),
                               rtol=1e-5)
    got = tps._edge_jacobians(tp, te)
    want = jax.jit(jps._edge_jacobians)(jp, je)
    for g, w, name in zip(got, want, ("ji", "jj", "r")):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=JAC_ATOL, err_msg=name)
    assert not got[0][0].any()                     # edge (0, 1): node 0 is the gauge
    # The measured scale ratio: 0 on chain edges, the drift on the loop.
    ls = tps.measured_rel_log_s(tp.rvecs, tp.tvecs, te.i, te.j, te.rel_tvec)
    want_ls = jax.jit(jps.measured_rel_log_s)(jp.rvecs, jp.tvecs, je.i, je.j, je.rel_tvec)
    np.testing.assert_allclose(ls.numpy(), np.asarray(want_ls), atol=1e-5)
    np.testing.assert_allclose(ls[:7].numpy(), 0.0, atol=1e-5)
    assert float(ls[7]) > 0.2


def test_sim3_fixes_scale_drift_where_se3_cannot():
    (gt_r, gt_t), (er, et), edges = _drifted_chain()
    (je, jp), (te, tp) = _both(edges, er, et)
    ate0 = _ate(tp.rvecs, tp.tvecs, gt_r, gt_t)
    se3_edges = tpg.PoseGraphEdges(te.i, te.j, te.rel_rvec, te.rel_tvec, te.weight)
    se3 = tpg.optimize_pose_graph(tpg.Poses(tp.rvecs, tp.tvecs), se3_edges, n_iters=15,
                                  damping=1e-4)
    ate_se3 = _ate(se3.rvecs, se3.tvecs, gt_r, gt_t)
    out = tps.optimize_sim3_graph(tp, te, n_iters=15, damping=1e-4)
    want = jax.jit(lambda p: jps.optimize_sim3_graph(p, je, n_iters=15, damping=1e-4))(jp)
    for g, w in zip(out, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=RUN_ATOL)
    rv, tv = tps.sim3_to_se3_poses(out)
    ate_sim3 = _ate(rv, tv, gt_r, gt_t)
    assert ate_sim3 < 0.5 * ate_se3 and ate_sim3 < 0.25 * ate0, (ate0, ate_se3, ate_sim3)
    ls = out.log_s.numpy()
    assert ls[0] == 0.0 and ls[-1] > ls[1]


def test_sim3_identity_on_consistent_chain():
    """Zero drift: the optimizer must not invent scales."""
    (gt_r, gt_t), _est, edges = _drifted_chain(per_edge_scale=1.0)
    n = len(gt_r)
    chain = {k: v[: n - 1] for k, v in _edges(gt_r, gt_t, gt_r, gt_t, np.zeros(0, int),
                                              np.zeros(0, int), 8.0).items()}
    _j, (te, tp) = _both(chain, gt_r, gt_t)
    assert float(tps.sim3_rms(tp, te)) < 1e-5
    out = tps.optimize_sim3_graph(tp, te, n_iters=5, damping=1e-4)
    np.testing.assert_allclose(out.log_s.numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(out.tvecs.numpy(), gt_t, atol=1e-4)


def test_sim3_cg_reaches_the_dense_fixed_point_and_matches_jax():
    """tests/test_pose_graph_sim3.py's gate (1e-3 to the dense fixed point
    after 20 steps, residual within 5%), and one CG step against JAX's."""
    _gt, (er, et), edges = _drifted_chain(n=16)
    (je, jp), (te, tp) = _both(edges, er, et)
    kw = dict(damping=1e-4, cg_iters=300, cg_tol=1e-12)
    dense = tps.optimize_sim3_graph(tp, te, n_iters=20, solver="dense", damping=1e-4)
    cg = tps.optimize_sim3_graph(tp, te, n_iters=20, solver="cg", **kw)
    for c, d in zip(cg, dense):
        np.testing.assert_allclose(c.numpy(), d.numpy(), atol=1e-3)
    assert float(tps.sim3_rms(cg, te)) < 1.05 * float(tps.sim3_rms(dense, te)) + 1e-4
    got = tps.sim3_step(tp, te, solver="cg", **kw)
    want = jax.jit(lambda p: jps.sim3_step(p, je, solver="cg", **kw))(jp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=STEP_RTOL, atol=STEP_ATOL)


def test_sim3_chain_step_is_the_dense_step_and_matches_jax():
    """The chain + Woodbury solve is exact: one step equals the dense solve
    and JAX's chain step to f32 round-off (the JAX test's chain-vs-dense
    tolerance, rtol 5e-4 and atol 2e-4: the sweeps round log_s at ~2e-4), and
    15 steps reach the dense fixed point (1e-4)."""
    _gt, (er, et), edges = _drifted_chain(n=20)
    (je, jp), (te, tp) = _both(edges, er, et)
    dense = tps.sim3_step(tp, te, damping=1e-4, solver="dense")
    chain = tps.sim3_step(tp, te, damping=1e-4, solver="chain", offchain_cap=4)
    want = jax.jit(lambda p: jps.sim3_step(p, je, damping=1e-4, solver="chain",
                                           offchain_cap=4))(jp)
    for c, d, w in zip(chain, dense, want):
        np.testing.assert_allclose(c.numpy(), d.numpy(), rtol=5e-4, atol=2e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(w), rtol=5e-4, atol=2e-4)
    d_out = tps.optimize_sim3_graph(tp, te, n_iters=15, damping=1e-4, solver="dense")
    c_out = tps.optimize_sim3_graph(tp, te, n_iters=15, damping=1e-4, solver="chain",
                                    offchain_cap=4)
    np.testing.assert_allclose(c_out.tvecs.numpy(), d_out.tvecs.numpy(), atol=1e-4)
    np.testing.assert_allclose(c_out.log_s.numpy(), d_out.log_s.numpy(), atol=1e-4)


def test_sim3_auto_dispatch_thresholds():
    lim = tps.SIM3_DENSE_LIMIT
    assert lim == jps.SIM3_DENSE_LIMIT
    for n, cap, want in ((lim, None, "dense"), (lim + 1, None, "cg"), (lim + 1, 8, "chain")):
        assert tps.resolve_sim3_solver(n, offchain_cap=cap) == want
        assert jps.resolve_sim3_solver(n, offchain_cap=cap) == want
    assert tps.resolve_sim3_solver(10_000, "dense") == "dense"
    assert tps.chain_damping(1000, 1e-4) == jps.chain_damping(1000, 1e-4)
    with pytest.raises(ValueError, match="solver must be"):
        tps.resolve_sim3_solver(4, "lu")


def test_sim3_thousand_node_scale_ramp_chain():
    """tests/test_pose_graph_sim3.py's 1,000-node chain with a multiplicative
    scale ramp to 1.5x and metric loops (i -> i + 200 every 100 nodes):
    "auto" with a loop cap takes the chain solver, recovers the ramp in
    log_s (endpoint within 0.15, correlation > 0.95) and shrinks the ATE
    below 0.15 of the drifted one, JAX's gates; the port and JAX agree to
    2e-3 after 12 chain GN steps (the block-Thomas sweeps add round-off
    along the chain)."""
    n = 1000
    rng = np.random.default_rng(3)
    th = np.linspace(0, 10 * np.pi, n)
    gt_t = np.stack([np.cos(th), np.sin(th), 0.05 * rng.normal(size=n)], 1).astype(np.float32)
    gt_r = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    er, et = _integrate(gt_r, gt_t, float(np.exp(np.log(1.5) / (n - 1))))
    loop_i = np.asarray(list(range(0, n - 200, 100)) + [n - 201], np.int32)
    edges = _edges(er, et, gt_r, gt_t, loop_i, loop_i + 200, 8.0)
    (je, jp), (te, tp) = _both(edges, er, et)
    cap = len(loop_i)
    assert tps.resolve_sim3_solver(n, offchain_cap=cap) == "chain"
    damping = tps.chain_damping(n, 1e-4)
    out = tps.optimize_sim3_graph(tp, te, n_iters=12, damping=damping, offchain_cap=cap)
    want = jax.jit(lambda p: jps.optimize_sim3_graph(p, je, n_iters=12, damping=damping,
                                                     offchain_cap=cap))(jp)
    for g, w in zip(out, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3)
    rv, tv = tps.sim3_to_se3_poses(out)
    ate0, ate1 = _ate(tp.rvecs, tp.tvecs, gt_r, gt_t), _ate(rv, tv, gt_r, gt_t)
    assert ate1 < 0.15 * ate0, (ate0, ate1)
    ls = out.log_s.numpy()
    ramp = np.log(1.5) * np.arange(n) / (n - 1)
    assert abs(ls[-1] - ramp[-1]) < 0.15 and np.corrcoef(ls, ramp)[0, 1] > 0.95


def test_sim3_padded_edges_and_converters():
    """Invalid (weight-0) slots change nothing; the converters round-trip."""
    _gt, (er, et), edges = _drifted_chain(n=8)
    _gt, _est, padded = _drifted_chain(n=8, pad=4)
    _j, (te, tp) = _both(edges, er, et)
    _j, (tpe, _p) = _both(padded, er, et)
    a = tps.optimize_sim3_graph(tp, te, n_iters=10, damping=1e-4)
    b = tps.optimize_sim3_graph(tp, tpe, n_iters=10, damping=1e-4)
    assert all(bool(torch.isfinite(t).all()) for t in b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5)
    back = tps.sim3_edges_to_numpy(tpe)
    assert back["i"].dtype == np.int32 and back["metric"].dtype == np.float32
    assert all(torch.equal(x, y) for x, y in zip(tpe, tps.sim3_edges_from_numpy(back, "cpu")))
