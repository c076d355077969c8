"""The port's SE(3) pose-graph optimization (``models/pose_graph``) against
the JAX package on the CPU: relative poses, residuals, the forward-mode
Jacobians (padded and near-identity edges included), ``optimize_pose_graph``
on tests/test_pose_graph.py's drifted circle with each solver (dense, CG,
chain + Woodbury), CG's trip count against a copy of the JAX while loop, the
block-tridiagonal solve, and "auto" at 300 nodes."""

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


def _chain_graph(rng, n, loop_every, noise=0.01):
    """A planar loop of ``n`` poses (it passes its start every 100 nodes), an
    odometry chain measured from the truth with noise, loop edges
    (i -> i + loop_every) from the truth, and the chain integrated from the
    noisy measurements as the start: the drift the loops must remove."""
    th = np.linspace(0, 2 * np.pi * n / 100, n)
    gt_t = np.stack([np.cos(th), np.sin(th), 0.05 * rng.normal(size=n)], 1).astype(np.float32)
    gt_r = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    rel = jax.jit(jax.vmap(jpg.relative_pose))
    cr, ct = (np.asarray(a) for a in rel(gt_r[:-1], gt_t[:-1], gt_r[1:], gt_t[1:]))
    cr = cr + rng.normal(size=cr.shape).astype(np.float32) * noise
    ct = ct + rng.normal(size=ct.shape).astype(np.float32) * noise
    li = np.arange(0, n - loop_every, loop_every, dtype=np.int32)
    lr, lt = (np.asarray(a) for a in rel(gt_r[li], gt_t[li], gt_r[li + loop_every],
                                         gt_t[li + loop_every]))
    # Integrate the noisy chain: R_{k+1} = R_rel R_k, t_{k+1} = R_rel t_k + t_rel.
    rod, log = jax.jit(jpg.rodrigues), jax.jit(jpg.rotation_log)
    est_r, est_t = [gt_r[0]], [gt_t[0]]
    for k in range(n - 1):
        R_rel = np.asarray(rod(cr[k]))
        est_t.append(R_rel @ est_t[-1] + ct[k])
        est_r.append(np.asarray(log(R_rel @ np.asarray(rod(est_r[-1])))))
    edges = dict(i=np.concatenate([np.arange(n - 1), li]).astype(np.int32),
                 j=np.concatenate([np.arange(1, n), li + loop_every]).astype(np.int32),
                 rel_rvec=np.concatenate([cr, lr]).astype(np.float32),
                 rel_tvec=np.concatenate([ct, lt]).astype(np.float32),
                 weight=np.concatenate([np.ones(n - 1), np.full(len(li), 8.0)]).astype(np.float32))
    start = dict(rvecs=np.stack(est_r).astype(np.float32), tvecs=np.stack(est_t).astype(np.float32))
    return (gt_r, gt_t), edges, start


@pytest.mark.parametrize("solver", ["cg", "chain"])
def test_scalable_solvers_match_dense_and_jax(rng, solver):
    """One GN step of the CG (run to convergence) and chain + Woodbury
    solvers is the dense step (f32 round-off: 2e-4), and each equals the JAX
    package's same solver; 25 steps reach the circle's truth."""
    _gt, edges, start = _circle(rng, noise=0.01)
    je, jp = _jax_graph(edges, start)
    te, tp = _torch_graph(edges, start)
    kw = dict(damping=1e-4, cg_iters=200, cg_tol=1e-12, offchain_cap=2)
    dense = tpg.pgo_step(tp, te, solver="dense", **kw)
    got = tpg.pgo_step(tp, te, solver=solver, **kw)
    want = jax.jit(lambda p: jpg.pgo_step(p, je, solver=solver, **kw))(jp)
    for g, d, w in zip(got, dense, want):
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=5e-4, atol=2e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=POSE_ATOL)
    out = tpg.optimize_pose_graph(tp, te, n_iters=25, solver=solver, **kw)
    assert float(tpg.pgo_rms(out, te)) < 0.5 * float(tpg.pgo_rms(tp, te))
    np.testing.assert_allclose(
        out.tvecs.numpy(),
        tpg.optimize_pose_graph(tp, te, n_iters=25, solver="dense", **kw).tvecs.numpy(),
        atol=1e-3)


def _jax_cg_trips(blk, cg_iters, cg_tol):
    """The JAX package's ``solve_pgo_cg`` while loop, copied with a trip
    counter (its cond and body verbatim, on the JAX arrays)."""
    jnp_ = jnp
    prec = lambda v: jnp_.einsum("nkl,nl->nk", blk.minv, v)
    x = jnp_.zeros_like(blk.b)
    r = blk.b
    z = prec(r)
    p = z
    rz = jnp_.sum(r * z)
    thresh = cg_tol * rz
    i = 0
    while i < cg_iters and bool(rz > thresh):
        ap = jpg.pgo_matvec(blk, p)
        pap = jnp_.sum(p * ap)
        alpha = jnp_.where(pap > 1e-20, rz / jnp_.maximum(pap, 1e-20), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = jnp_.sum(r * z)
        p = z + jnp_.where(rz > 1e-20, rz_new / jnp_.maximum(rz, 1e-20), 0.0) * p
        rz = rz_new
        i += 1
    return i, x


@pytest.mark.parametrize("cg_tol", [1e-4, 1e-8])
def test_cg_trip_count_matches_the_jax_while_loop(rng, cg_tol):
    """The port's CG runs every trip and masks the ones past JAX's stop: the
    trips that changed x equal the JAX loop's count, and x its result."""
    _gt, edges, start = _circle(rng, noise=0.01)
    je, jp = _jax_graph(edges, start)
    te, tp = _torch_graph(edges, start)
    jblk = jax.jit(jpg.assemble_pgo_implicit)(jp, je, 1e-4)
    want_trips, want_x = _jax_cg_trips(jblk, 60, cg_tol)
    x, trips = tpg.pgo_pcg(tpg.assemble_pgo_implicit(tp, te, 1e-4), cg_iters=60, cg_tol=cg_tol)
    assert int(trips) == want_trips and 0 < want_trips < 60
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), atol=1e-5)
    # The matvec itself, against JAX's on the same blocks.
    v = rng.normal(size=(x.shape[0], 6)).astype(np.float32)
    blk = tpg.ImplicitPgo(*(torch.from_numpy(np.array(a)) for a in jblk))
    np.testing.assert_allclose(tpg.pgo_matvec(blk, torch.from_numpy(v)).numpy(),
                               np.asarray(jpg.pgo_matvec(jblk, jnp.asarray(v))),
                               rtol=1e-5, atol=1e-4)


def test_block_tridiag_solve_matches_dense_and_jax(rng):
    """Two sweeps of block-Thomas on a random SPD block-tridiagonal system
    with several right-hand sides: the dense solution (f32, 1e-4 relative)
    and JAX's scans."""
    n, d, k = 9, 6, 3
    a = rng.normal(size=(n, d, d)).astype(np.float32)
    diag = (a @ a.transpose(0, 2, 1) + 8 * np.eye(d)).astype(np.float32)
    off = (0.5 * rng.normal(size=(n - 1, d, d))).astype(np.float32)
    rhs = rng.normal(size=(n, d, k)).astype(np.float32)
    got = tpg.block_tridiag_solve(*map(torch.from_numpy, (diag, off, rhs))).numpy()
    dense = np.zeros((n * d, n * d))
    for i in range(n):
        dense[i * d:(i + 1) * d, i * d:(i + 1) * d] = diag[i]
        if i < n - 1:
            dense[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d] = off[i]
            dense[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = off[i].T
    want = np.linalg.solve(dense, rhs.reshape(n * d, k)).reshape(n, d, k)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jpg.block_tridiag_solve)(diag, off, rhs)),
                               atol=1e-5)


def test_auto_dispatch_at_300_nodes_matches_dense_and_jax():
    """300 nodes: above the dense limit "auto" takes the chain solver when
    the caller caps the loop edges, else CG. The chain step equals the dense
    one (f32: 5e-4) and JAX's chain step; 6 chain GN steps remove most of
    the integrated drift and equal JAX's to 1e-3."""
    n = 300
    _gt, edges, start = _chain_graph(np.random.default_rng(3), n, loop_every=50)
    je, jp = _jax_graph(edges, start)
    te, tp = _torch_graph(edges, start)
    cap = int((edges["j"] != edges["i"] + 1).sum())
    assert tpg.resolve_pgo_solver(n, "auto", cap) == "chain"
    assert jpg.resolve_pgo_solver(n, "auto", cap) == "chain"
    assert tpg.resolve_pgo_solver(n) == jpg.resolve_pgo_solver(n) == "cg"
    damping = tpg.chain_damping(n, 1e-4)
    assert damping == jpg.chain_damping(n, 1e-4) < 1e-4
    chain = tpg.pgo_step(tp, te, damping, solver="chain", offchain_cap=cap)
    dense = tpg.pgo_step(tp, te, damping, solver="dense")
    want = jax.jit(lambda p: jpg.pgo_step(p, je, damping, solver="chain", offchain_cap=cap))(jp)
    for g, d, w in zip(chain, dense, want):
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-4)
    out = tpg.optimize_pose_graph(tp, te, n_iters=6, damping=damping, offchain_cap=cap)
    jout = jax.jit(lambda p: jpg.optimize_pose_graph(p, je, n_iters=6, damping=damping,
                                                     offchain_cap=cap))(jp)
    np.testing.assert_allclose(out.tvecs.numpy(), np.asarray(jout.tvecs), atol=1e-3)
    assert float(tpg.pgo_rms(out, te)) < 0.2 * float(tpg.pgo_rms(tp, te))


def test_resolve_pgo_solver_and_converters():
    assert tpg.resolve_pgo_solver(256) == jpg.resolve_pgo_solver(256) == "dense"
    assert tpg.resolve_pgo_solver(257, offchain_cap=4) == "chain"
    assert tpg.resolve_pgo_solver(10_000, "dense") == "dense"
    assert tpg.PGO_DENSE_LIMIT == jpg.PGO_DENSE_LIMIT
    with pytest.raises(ValueError, match="solver must be"):
        tpg.resolve_pgo_solver(4, "lu")
    edges = tpg.PoseGraphEdges(torch.zeros(1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32), torch.zeros(1, 3),
                               torch.zeros(1, 3), torch.ones(1))
    # The converters round-trip, dtypes kept.
    back = tpg.pose_graph_edges_to_numpy(edges)
    assert back["i"].dtype == np.int32 and back["weight"].dtype == np.float32
    again = tpg.pose_graph_edges_from_numpy(back, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(edges, again))
