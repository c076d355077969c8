"""The port's bundle adjustment (``models/ba``) against the JAX package on the
CPU: normal-block assembly and the dense Schur solve (with and without Huber
weights and anchors), the CG group plan, the implicit blocks, the Schur
matvec, the masked CG against the JAX while loop, ``bundle_adjust`` with
both solvers, ``bundle_adjust_lm``, ``robust_cost`` and ``resolve_solver``.
The scenes are tests/test_geometry_ba.py's: cameras on an arc, all
observing all points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sift_parallel_optimization_tpu.models import ba as jba
from sift_parallel_optimization_tpu.models.geometry import project as jproject
from sift_parallel_optimization_tpu_torch.models import ba as tba
from sift_parallel_optimization_tpu_torch.utils.convert import tuple_from_numpy
from sift_parallel_optimization_tpu_torch.utils.trajectory import (
    camera_centers,
    umeyama_alignment,
)

K_NP = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)
K_J, K_T = jnp.asarray(K_NP), torch.from_numpy(K_NP)
# Normal blocks: the same fp32 products summed in another order; entries
# reach ~1e7, so they agree to 1e-5 of the largest entry of each block, and
# the gradients (sums of residual products that cancel) to 1e-4 of theirs.
BLOCK_RTOL = 1e-5
GRAD_RTOL = 1e-4
# One damped solve of those blocks: the reduced system's condition number is
# up to ~1/damping, so the update agrees to 2e-2 of its largest entry (and to
# 1e-3 when the port solves JAX's own blocks: another LU, other sums).
STEP_RTOL = 2e-2
# Converged states after several GN steps: 1e-4 of the scene's extent.
STATE_RTOL = 1e-4


def _scene(rng, n_cams=6, n_pts=60, outliers=False, drop_every=0):
    """tests/test_geometry_ba.py's ``_ba_scene`` in numpy, a perturbed start,
    and 20 anchors (a fifth invalid)."""
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    rv = np.array([[0.0, 0.08 * (i - n_cams / 2), 0.0] for i in range(n_cams)], np.float32)
    tv = np.array([[0.4 * (i - n_cams / 2), 0.0, 0.0] for i in range(n_cams)], np.float32)
    cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.concatenate([np.asarray(jproject(jnp.asarray(pts), jnp.asarray(rv[i]),
                                             jnp.asarray(tv[i]), K_J)[0])
                         for i in range(n_cams)])
    clean_uv = uv.copy()
    if outliers:
        uv[::17] += 60.0
    valid = np.ones(len(cam), bool)
    if drop_every:
        valid[::drop_every] = False
    noisy = (rv + 0.01 * rng.normal(size=rv.shape).astype(np.float32),
             tv + 0.03 * rng.normal(size=tv.shape).astype(np.float32),
             pts + 0.05 * rng.normal(size=pts.shape).astype(np.float32))
    # Anchors: 20 observations against their landmarks' true (frozen)
    # positions, a fifth of the slots invalid.
    rows = rng.choice(len(cam), 20, replace=False)
    anchors = dict(cam_idx=cam[rows], xyz=pts[pt[rows]], uv=clean_uv[rows],
                   valid=np.arange(20) % 5 != 0)
    return dict(gt=(rv, tv, pts), start=noisy, obs=(cam, pt, uv, valid),
                clean=(cam, pt, clean_uv, np.ones(len(cam), bool)), anchors=anchors)


def _jax(s, key):
    if key == "anchors":
        return jba.Anchors(**{k: jnp.asarray(v) for k, v in s["anchors"].items()})
    cls = jba.BAState if key in ("gt", "start") else jba.Observations
    return cls(*map(jnp.asarray, s[key]))


def _torch(s, key):
    if key == "anchors":
        return tba.anchors_from_numpy(s["anchors"], "cpu")
    cls = tba.BAState if key in ("gt", "start") else tba.Observations
    return cls(*[torch.from_numpy(a) for a in s[key]])


def _close(got, want, rtol, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * scale, err_msg=name)


def _rtol(field):
    return GRAD_RTOL if field in ("bc", "bp") else BLOCK_RTOL


@pytest.mark.parametrize("huber", [None, 2.0])
@pytest.mark.parametrize("with_anchors", [False, True])
def test_normal_blocks_and_schur_match_jax(rng, huber, with_anchors):
    s = _scene(rng, outliers=huber is not None, drop_every=7)
    ja = _jax(s, "anchors") if with_anchors else None
    ta = _torch(s, "anchors") if with_anchors else None
    want = jax.jit(lambda st, o, a: jba.assemble_normal_blocks(st, o, K_J, huber, anchors=a))(
        _jax(s, "start"), _jax(s, "obs"), ja)
    got = tba.assemble_normal_blocks(_torch(s, "start"), _torch(s, "obs"), K_T, huber,
                                     anchors=ta)
    for f in tba.NormalBlocks._fields:
        _close(getattr(got, f), getattr(want, f), _rtol(f), f)
    jd = jax.jit(lambda b: jba.solve_schur(b, 1e-3))(want)
    td = tba.solve_schur(got, 1e-3)
    _close(td[0], jd[0], STEP_RTOL, "delta_c")
    _close(td[1], jd[1], STEP_RTOL, "delta_p")
    assert float(td[0][0].abs().max()) == 0.0          # camera 0 frozen
    # The same blocks in both solvers: the port's solve of JAX's blocks.
    tb = tuple_from_numpy(tba.NormalBlocks, want, {}, "cpu")
    td2 = tba.solve_schur(tb, 1e-3)
    _close(td2[0], jd[0], 1e-3, "delta_c of JAX's blocks")


@pytest.mark.parametrize("capacity", [None, 4])
def test_group_plan_equals_jax(rng, capacity):
    """Element for element, including an overflowing capacity (4 slots for 6
    observations a point) and its n_dropped count."""
    s = _scene(rng, drop_every=7)
    want = jba.make_group_plan(_jax(s, "obs"), 6, 60, capacity)
    got = tba.make_group_plan(_torch(s, "obs"), 6, 60, capacity)
    for f in tba.GroupPlan._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    if capacity == 4:
        assert int(got.n_dropped) > 0
        assert int(got.n_dropped) + int(got.valid.sum()) == int(s["obs"][3].sum())


def test_implicit_blocks_and_schur_matvec(rng):
    s = _scene(rng, outliers=True, drop_every=7)
    args = (1e-3, 2.0)
    want = jax.jit(lambda st, o, a: jba.assemble_implicit_blocks(
        st, o, K_J, *args, anchors=a))(_jax(s, "start"), _jax(s, "obs"), _jax(s, "anchors"))
    blk = tba.assemble_implicit_blocks(_torch(s, "start"), _torch(s, "obs"), K_T, *args,
                                       anchors=_torch(s, "anchors"))
    for f in tba.ImplicitBlocks._fields:
        _close(getattr(blk, f), getattr(want, f), _rtol(f), f)
    # S x against the dense S = Hcc - W Hpp^-1 W^T of the port's dense blocks.
    nb = tba.assemble_normal_blocks(_torch(s, "start"), _torch(s, "obs"), K_T, 2.0,
                                    anchors=_torch(s, "anchors"))
    C, P = 6, 60
    hcc = tba._damp_blocks(nb.hcc, 1e-3)
    hcc[0] = torch.eye(6)
    hpp_inv = tba._inv3x3(tba._damp_blocks(nb.hpp, 1e-3))
    w = nb.w.permute(0, 2, 1, 3).reshape(6 * C, P, 3)
    s_dense = -torch.einsum("ipk,pkl,jpl->ij", w, hpp_inv, w) + torch.block_diag(*hcc)
    x = torch.from_numpy(rng.normal(size=(C, 6)).astype(np.float32))
    got = tba.schur_matvec(blk, x)
    _close(got, (s_dense @ x.reshape(-1)).reshape(C, 6).numpy(), 1e-4)


def _jax_cg_iterations(blk, cg_iters, cg_tol):
    """The JAX package's solve_schur_cg loop with its trip count returned."""
    y0 = jnp.einsum("pkl,pl->pk", blk.hpp_inv, blk.bp)
    b = blk.bc - jba._w_apply(blk, y0)
    minv = jnp.linalg.inv(blk.hcc)
    prec = lambda v: jnp.einsum("ckl,cl->ck", minv, v)
    r = b
    z = prec(r)
    rz = jnp.sum(r * z)
    thresh = cg_tol * rz

    def body(c):
        i, x, r, p, rz = c
        ap = jba.schur_matvec(blk, p)
        pap = jnp.sum(p * ap)
        alpha = jnp.where(pap > 1e-20, rz / jnp.maximum(pap, 1e-20), 0.0)
        x, r = x + alpha * p, r - alpha * ap
        z = prec(r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(rz > 1e-20, rz_new / jnp.maximum(rz, 1e-20), 0.0)
        return i + 1, x, r, z + beta * p, rz_new

    with jax.default_matmul_precision("highest"):
        out = lax.while_loop(lambda c: (c[0] < cg_iters) & (c[4] > thresh), body,
                             (0, jnp.zeros_like(b), r, z, rz))
    return out[0]


@pytest.mark.parametrize("cg_tol", [0.0, 1e-8, 1e-4])
def test_solve_schur_cg_stops_where_jax_stops(rng, cg_tol):
    """The masked fixed-trip CG on JAX's own blocks: the same update, and the
    same number of iterations as the JAX while loop (all 25 at cg_tol=0)."""
    s = _scene(rng, outliers=True)
    jblk = jax.jit(lambda st, o: jba.assemble_implicit_blocks(st, o, K_J, 1e-3, 2.0))(
        _jax(s, "start"), _jax(s, "obs"))
    want = jax.jit(lambda b: jba.solve_schur_cg(b, cg_tol=cg_tol))(jblk)
    n_want = int(jax.jit(lambda b: _jax_cg_iterations(b, 25, cg_tol))(jblk))
    blk = tuple_from_numpy(tba.ImplicitBlocks, jblk, {}, "cpu")
    got = tba.solve_schur_cg(blk, cg_tol=cg_tol)
    _, n_got = tba.schur_pcg(blk, cg_tol=cg_tol)
    assert int(n_got) == n_want
    if cg_tol == 0.0:
        assert n_want == 25
    else:
        assert n_want < 25
    # CG over 25 trips amplifies rounding of the matvec sums: 1e-3 of the
    # update's largest entry.
    _close(got[0], want[0], 1e-3, "delta_c")
    _close(got[1], want[1], 1e-3, "delta_p")


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("with_anchors", [False, True])
def test_bundle_adjust_matches_jax(rng, solver, with_anchors):
    s = _scene(rng, outliers=True)
    ja = _jax(s, "anchors") if with_anchors else None
    ta = _torch(s, "anchors") if with_anchors else None
    kw = dict(n_iters=8, damping=1e-4, huber_delta=2.0, solver=solver)
    want = jax.jit(lambda st, a: jba.bundle_adjust(st, _jax(s, "obs"), K_J, anchors=a, **kw))(
        _jax(s, "start"), ja)
    got = tba.bundle_adjust(_torch(s, "start"), _torch(s, "obs"), K_T, anchors=ta, **kw)
    for f in tba.BAState._fields:
        _close(getattr(got, f), getattr(want, f), STATE_RTOL, f)
    # Robust BA survives the outliers: the clean observations reproject well.
    assert float(tba.rms_error(got, _torch(s, "clean"), K_T)) < 1.0


def _gauge_gap(a: tba.BAState, b: tba.BAState) -> float:
    """Largest distance between two solutions' camera centers and points
    after the Sim(3) alignment of b onto a, over a's extent: with camera 0
    fixed, monocular BA leaves the scale about camera 0 free, and two solvers
    may settle it differently while agreeing on everything else."""
    xa = torch.cat([camera_centers(a.rvecs, a.tvecs), a.points]).double()
    xb = torch.cat([camera_centers(b.rvecs, b.tvecs), b.points]).double()
    s, R, t = umeyama_alignment(xb, xa)
    return float((s * xb @ R.T + t - xa).abs().max() / (xa - xa.mean(0)).abs().max())


def test_cg_and_dense_reach_one_fixed_point(rng):
    """tests/test_geometry_ba.py's gate for the port: both solvers from the
    same start land on the same state, up to the free scale: rotations
    within 1e-4 rad, the aligned structure within 1e-4 of its extent."""
    s = _scene(rng)
    st, obs = _torch(s, "start"), _torch(s, "obs")
    dense = tba.bundle_adjust(st, obs, K_T, n_iters=20, damping=1e-4, solver="dense")
    cg = tba.bundle_adjust(st, obs, K_T, n_iters=20, damping=1e-4, solver="cg")
    e_dense = float(tba.rms_error(dense, obs, K_T))
    assert e_dense < 0.05
    assert float(tba.rms_error(cg, obs, K_T)) < max(2.0 * e_dense, 0.01)
    assert float((dense.rvecs - cg.rvecs).abs().max()) < 1e-4
    assert _gauge_gap(dense, cg) < 1e-4


def test_bundle_adjust_lm_matches_jax(rng):
    """The start where fixed-lambda GN stalls (tests/test_geometry_ba.py,
    seed 3): LM converges in both packages, through its rejected steps."""
    s = _scene(rng)
    r2 = np.random.default_rng(3)
    rv, tv, pts = s["gt"]
    bad = (rv + 0.3 * r2.normal(size=rv.shape).astype(np.float32),
           tv + 0.6 * r2.normal(size=tv.shape).astype(np.float32),
           pts + 0.3 * r2.normal(size=pts.shape).astype(np.float32))
    kw = dict(max_iters=40, lambda_init=1e-2)
    want = jax.jit(lambda st: jba.bundle_adjust_lm(st, _jax(s, "obs"), K_J, **kw))(
        jba.BAState(*map(jnp.asarray, bad)))
    got = tba.bundle_adjust_lm(tba.BAState(*map(torch.from_numpy, bad)), _torch(s, "obs"),
                               K_T, **kw)
    e_want = float(jba.rms_error(want, _jax(s, "obs"), K_J))
    e_got = float(tba.rms_error(got, _torch(s, "obs"), K_T))
    assert e_got < 1e-2 and e_want < 1e-2, (e_got, e_want)
    for f in tba.BAState._fields:
        _close(getattr(got, f), getattr(want, f), 1e-3, f)
    # LM never raises the cost, and with anchors it holds them too.
    c0 = float(tba.robust_cost(tba.BAState(*map(torch.from_numpy, bad)), _torch(s, "obs"), K_T))
    assert float(tba.robust_cost(got, _torch(s, "obs"), K_T)) <= c0
    ta = _torch(s, "anchors")
    anc = tba.bundle_adjust_lm(_torch(s, "start"), _torch(s, "obs"), K_T, max_iters=6,
                               huber_delta=2.0, anchors=ta, solver="cg")
    c_start = float(tba.robust_cost(_torch(s, "start"), _torch(s, "obs"), K_T, 2.0, ta))
    assert float(tba.robust_cost(anc, _torch(s, "obs"), K_T, 2.0, ta)) <= c_start


@pytest.mark.parametrize("huber", [None, 2.0])
def test_robust_cost_and_anchor_residuals_match_jax(rng, huber):
    s = _scene(rng, outliers=True, drop_every=5)
    want = float(jba.robust_cost(_jax(s, "start"), _jax(s, "obs"), K_J, huber,
                                 anchors=_jax(s, "anchors")))
    got = float(tba.robust_cost(_torch(s, "start"), _torch(s, "obs"), K_T, huber,
                                anchors=_torch(s, "anchors")))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ra = tba.anchor_residuals(_torch(s, "start"), _torch(s, "anchors"), K_T)
    ja = jba.anchor_residuals(_jax(s, "start"), _jax(s, "anchors"), K_J)
    np.testing.assert_allclose(ra.numpy(), np.asarray(ja), atol=1e-3)
    assert not ra.numpy()[~s["anchors"]["valid"]].any()
    hw = tba._huber_weights(torch.tensor([[3.0, 4.0], [0.5, 0.0]]), 2.0)
    np.testing.assert_allclose(hw.numpy(), [0.4, 1.0])


def test_resolve_solver_and_containers():
    for c, p, want in ((6, 60, "dense"), (8, 1024, "dense"), (50, 6400, "cg"),
                       (200, 4000, "cg"), (64, 1024, "cg"), (63, 1024, "dense")):
        assert tba.resolve_solver(c, p, "auto") == jba.resolve_solver(c, p, "auto") == want
    assert tba.resolve_solver(2, 2, "cg") == "cg"
    assert tba.resolve_solver(1000, 1000, "dense") == "dense"
    assert tba.DENSE_CROSS_LIMIT == jba.DENSE_CROSS_LIMIT
    for m, p in ((100, 10), (7, 100), (5000, 64)):
        assert tba._cg_capacity(m, p, None) == jba._cg_capacity(m, p, None)
    e = tba.empty_anchors(5, device="cpu")
    assert e.count() == 0 and e.xyz.shape == (5, 3) and e.cam_idx.dtype == torch.int32
    back = tba.anchors_to_numpy(tba.anchors_from_numpy(jba.empty_anchors(5), "cpu"))
    assert set(back) == set(jba.Anchors._fields) and back["valid"].dtype == bool
    with pytest.raises(ValueError, match="solver"):
        tba.ba_step(tba.BAState(torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(4, 3)),
                    tba.Observations(torch.zeros(1, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32), torch.zeros(1, 2),
                                     torch.zeros(1, dtype=torch.bool)), K_T, solver="lu")
