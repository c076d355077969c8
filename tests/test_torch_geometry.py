"""The port's geometry primitives and analytic Jacobians against the JAX
package: the same numpy-seeded inputs through both, on the CPU.

Tolerance: rtol 1e-5 / atol 1e-6 unless a test says why not. Both sides run
the same closed-form fp32 expressions; they differ in the summation order
of small matrix products and in libm. The JAX side runs under ``jax.jit``,
as the package's callers run it: one compilation per function instead of
one per primitive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import ba as jba
from sift_parallel_optimization_tpu.models import geometry as jgeo
from sift_parallel_optimization_tpu_torch.models import ba as tba
from sift_parallel_optimization_tpu_torch.models import geometry as tgeo

RTOL, ATOL = 1e-5, 1e-6
K_NP = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
K_J, K_T = jnp.asarray(K_NP), torch.from_numpy(K_NP)
J_RODRIGUES = jax.jit(jgeo.rodrigues)
J_ROTATION_LOG = jax.jit(jax.vmap(jgeo.rotation_log))
J_PROJECT = jax.jit(lambda pts, rvec, tvec: jgeo.project(pts, rvec, tvec, K_J))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def t(a):
    return torch.from_numpy(np.array(a))


def _scene(rng, n_pts=64):
    pts = rng.uniform(-1, 1, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    return pts


def _psd(rng, batch, n):
    a = rng.normal(size=(batch, 2 * n, n)).astype(np.float32)
    return np.einsum("bki,bkj->bij", a, a)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 12])
def test_block_inverse_matches_jax(rng, n):
    m = _psd(rng, 5, n) + np.eye(n, dtype=np.float32)
    want = jax.jit(jgeo._block_inv)(jnp.asarray(m))
    got = tgeo._block_inv(t(m))
    # Entries of an inverse carry the matrix's condition number (~1e2 here).
    close(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose((got @ t(m)).numpy(), np.broadcast_to(np.eye(n), m.shape),
                               atol=2e-3)


@pytest.mark.parametrize("fn", ["_inv2", "_inv3", "_inv4"])
def test_closed_form_inverses_match_jax(rng, fn):
    n = int(fn[-1])
    m = rng.normal(size=(7, n, n)).astype(np.float32) + 2 * np.eye(n, dtype=np.float32)
    # A general matrix near singular amplifies the last-bit differences.
    close(getattr(tgeo, fn)(t(m)), jax.jit(getattr(jgeo, fn))(jnp.asarray(m)), rtol=1e-4,
          atol=1e-5)


@pytest.mark.parametrize("n", [4, 12])
def test_smallest_eigvec_matches_jax(rng, n):
    a = rng.normal(size=(6, 2 * n, n)).astype(np.float32)
    null = rng.normal(size=(6, n)).astype(np.float32)
    null /= np.linalg.norm(null, axis=-1, keepdims=True)
    a = a - (a @ null[..., None]) * null[:, None, :]        # exact null vector
    ata = np.einsum("bki,bkj->bij", a, a)
    want = np.asarray(jax.jit(jgeo.smallest_eigvec)(jnp.asarray(ata)))
    got = tgeo.smallest_eigvec(t(ata)).numpy()
    # Inverse iteration amplifies by 1e6: compare directions, at 1e-4.
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.abs((got * null).sum(-1)), 1.0, atol=1e-4)


def test_psd_solve_matches_jax(rng):
    h = _psd(rng, 8, 6) + 0.1 * np.eye(6, dtype=np.float32)
    rhs = rng.normal(size=(8, 6)).astype(np.float32)
    # The solution carries the system's condition number.
    close(tgeo._psd_solve(t(h), t(rhs)),
          jax.jit(jgeo._psd_solve)(jnp.asarray(h), jnp.asarray(rhs)), rtol=1e-4, atol=1e-5)


def test_polar_rotation_matches_jax(rng):
    w = rng.normal(size=(9, 3)).astype(np.float32)
    m = np.asarray(J_RODRIGUES(jnp.asarray(w))) * rng.uniform(0.5, 2.0, (9, 1, 1))
    m = (m + 0.05 * rng.normal(size=m.shape)).astype(np.float32)
    close(tgeo.polar_rotation(t(m)), jax.jit(jgeo.polar_rotation)(jnp.asarray(m)), atol=1e-5)


@pytest.mark.parametrize("scale", [0.0, 1e-8, 1e-3, 0.8, 3.0])
def test_rodrigues_matches_jax(rng, scale):
    w = (rng.normal(size=(16, 3)) * scale).astype(np.float32)
    R = tgeo.rodrigues(t(w))
    close(R, J_RODRIGUES(jnp.asarray(w)))
    np.testing.assert_allclose((R @ R.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


@pytest.mark.parametrize("angle", [0.0, 1e-7, 0.3, 2.0, np.pi - 1e-4, np.pi])
def test_rotation_log_matches_jax(rng, angle):
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    R = np.asarray(J_RODRIGUES(jnp.asarray((axis * angle).astype(np.float32))))
    want = J_ROTATION_LOG(jnp.asarray(R))
    # Near pi the axis comes from sqrt-conditioned entries of R + I.
    close(tgeo.rotation_log(t(R)), want, atol=1e-5)
    close(tgeo.rotation_log(t(R[0])), want[0], atol=1e-5)


def test_camera_matrix_and_project_match_jax(rng):
    pts = _scene(rng)
    rvec = np.array([0.1, -0.2, 0.05], np.float32)
    tvec = np.array([0.3, -0.1, 0.4], np.float32)
    close(tgeo.Camera(t(rvec), t(tvec)).matrix(K_T),
          jax.jit(lambda r, s: jgeo.Camera(r, s).matrix(K_J))(jnp.asarray(rvec),
                                                              jnp.asarray(tvec)),
          rtol=1e-5, atol=1e-4)
    want_uv, want_z = J_PROJECT(jnp.asarray(pts), jnp.asarray(rvec), jnp.asarray(tvec))
    got_uv, got_z = tgeo.project(t(pts), t(rvec), t(tvec), K_T)
    close(got_uv, want_uv, atol=1e-4)     # pixels of magnitude ~3e2
    close(got_z, want_z)
    # A batch of poses broadcasts over one point set.
    rv = (rng.normal(size=(5, 3)) * 0.2).astype(np.float32)
    tv = (rng.normal(size=(5, 3)) * 0.2).astype(np.float32)
    want = jax.jit(jax.vmap(lambda r, s: jgeo.project(jnp.asarray(pts), r, s, K_J)[0]))(
        jnp.asarray(rv), jnp.asarray(tv))
    close(tgeo.project(t(pts), t(rv), t(tv), K_T)[0], want, atol=1e-4)


def _two_views(rng, n=64):
    pts = _scene(rng, n)
    r2 = np.array([0.02, 0.3, 0.01], np.float32)
    t2 = np.array([-0.8, 0.05, 0.1], np.float32)
    zero = jnp.zeros(3)
    p1, _ = J_PROJECT(jnp.asarray(pts), zero, zero)
    p2, _ = J_PROJECT(jnp.asarray(pts), jnp.asarray(r2), jnp.asarray(t2))
    return pts, r2, t2, np.asarray(p1), np.asarray(p2)


def test_triangulate_matches_jax(rng):
    pts, r2, t2, p1, p2 = _two_views(rng)
    P1 = jgeo.Camera(jnp.zeros(3), jnp.zeros(3)).matrix(K_J)
    P2 = jgeo.Camera(jnp.asarray(r2), jnp.asarray(t2)).matrix(K_J)
    want = jax.jit(jgeo.triangulate)(P1, P2, jnp.asarray(p1), jnp.asarray(p2))
    got = tgeo.triangulate(t(P1), t(P2), t(p1), t(p2))
    # The JAX package's own roundtrip gate is 1e-2; the two implementations
    # of the same inverse iteration agree far closer.
    close(got, want, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), pts, atol=1e-2)


def _essential(t_unit, R):
    tx = np.array([[0, -t_unit[2], t_unit[1]], [t_unit[2], 0, -t_unit[0]],
                   [-t_unit[1], t_unit[0], 0]], np.float32)
    return (tx @ R).astype(np.float32)


def test_essential_from_fundamental_matches_jax(rng):
    E = _essential(np.array([0.3, -0.2, 0.1], np.float32),
                   np.asarray(J_RODRIGUES(jnp.asarray([0.1, 0.05, -0.2]))))
    Kinv = np.linalg.inv(K_NP)
    F = (Kinv.T @ E @ Kinv).astype(np.float32)
    got = tgeo.essential_from_fundamental(t(F), K_T)
    close(got, jax.jit(jgeo.essential_from_fundamental)(jnp.asarray(F), K_J), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), E, atol=1e-4)


def test_decompose_essential_gives_the_four_candidates(rng):
    # The SVD's u, vt are defined up to sign, so the candidates are compared
    # as a set with the JAX package's, not slot for slot.
    R_true = np.asarray(J_RODRIGUES(jnp.asarray([0.0, 0.2, 0.0])))
    t_unit = np.array([-1.0, 0.1, 0.05], np.float32)
    t_unit /= np.linalg.norm(t_unit)
    E = _essential(t_unit, R_true)
    Rs, ts = tgeo.decompose_essential(t(E))
    jRs, jts = jax.jit(jgeo.decompose_essential)(jnp.asarray(E))
    assert Rs.shape == (4, 3, 3) and ts.shape == (4, 3)
    for R, tv in zip(Rs.numpy(), ts.numpy()):
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(R) - 1) < 1e-5
        d = [np.abs(R - np.asarray(a)).max() + np.abs(tv - np.asarray(b)).max()
             for a, b in zip(jRs, jts)]
        assert min(d) < 1e-4
    assert min(np.abs(R - R_true).max() for R in Rs.numpy()) < 1e-4


def test_recover_pose_matches_jax(rng):
    pts = _scene(rng, 96)
    R_true = np.asarray(J_RODRIGUES(jnp.asarray([0.0, 0.2, 0.0])))
    t_true = np.array([-1.0, 0.1, 0.05], np.float32)
    t_unit = t_true / np.linalg.norm(t_true)
    E = _essential(t_unit, R_true)
    p1 = np.asarray(J_PROJECT(jnp.asarray(pts), jnp.zeros(3), jnp.zeros(3))[0])
    p2 = np.asarray(J_PROJECT(jnp.asarray(pts), J_ROTATION_LOG(jnp.asarray(R_true)[None])[0],
                              jnp.asarray(t_true))[0])
    mask = np.ones(96, bool)
    mask[:5] = False
    want = jax.jit(jgeo.recover_pose)(jnp.asarray(E), jnp.asarray(p1), jnp.asarray(p2), K_J,
                                      jnp.asarray(mask))
    got = tgeo.recover_pose(t(E), t(p1), t(p2), K_T, t(mask))
    # Outputs, not the SVD's factors: R, t at 1e-5; points (depth ~5, through
    # a triangulation) at 1e-3; the front mask exactly.
    close(got[0], want[0], atol=1e-5)
    close(got[1], want[1], atol=1e-5)
    close(got[2], want[2], atol=1e-3)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[0].numpy(), R_true, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), t_unit, atol=1e-3)
    assert int(got[3].sum()) == 91


@pytest.mark.parametrize("outliers", [False, True])
def test_pnp_dlt_matches_jax(rng, outliers):
    pts = _scene(rng, 48)
    rvec = jnp.asarray([0.1, -0.2, 0.05])
    tvec = jnp.asarray([0.3, -0.1, 0.4])
    uv = np.array(J_PROJECT(jnp.asarray(pts), rvec, tvec)[0])
    w = np.ones(48, np.float32)
    if outliers:
        uv[:8] += rng.uniform(40, 80, (8, 2)).astype(np.float32)
        w[:8] = 0.0
    want = jax.jit(jgeo.pnp_dlt)(jnp.asarray(pts), jnp.asarray(uv), K_J, jnp.asarray(w))
    got = tgeo.pnp_dlt(t(pts), t(uv), K_T, t(w))
    # A null vector by inverse iteration, then three Gauss-Newton steps:
    # 1e-4 on a pose of magnitude ~0.4.
    close(got.rvec, want.rvec, atol=1e-4)
    close(got.tvec, want.tvec, atol=1e-4)
    err = tgeo.reprojection_error(got, t(pts), t(uv), K_T)
    close(err, jax.jit(jgeo.reprojection_error)(want, jnp.asarray(pts), jnp.asarray(uv), K_J),
          atol=2e-2)             # pixels, at the 1e-4 pose agreement above
    assert float(err[8:].median()) < 0.5


@pytest.mark.parametrize("n", [12, 6])
def test_pnp_dlt_batch_equals_vmap(rng, n):
    pts = _scene(rng, 48)
    rvec, tvec = jnp.asarray([0.1, -0.2, 0.05]), jnp.asarray([0.3, -0.1, 0.4])
    uv = np.asarray(J_PROJECT(jnp.asarray(pts), rvec, tvec)[0])
    idx = np.stack([rng.permutation(48)[:n] for _ in range(64)])
    idx[3, :n // 2] = idx[3, n // 2:]           # a degenerate sample: repeats
    want = jax.jit(jax.vmap(lambda p3, p2: jgeo.pnp_dlt(p3, p2, K_J, jnp.ones(n))))(
        jnp.asarray(pts[idx]), jnp.asarray(uv[idx]))
    got = tgeo.pnp_dlt(t(pts[idx]), t(uv[idx]), K_T, torch.ones(64, n))
    assert got.rvec.shape == got.tvec.shape == (64, 3)
    clean = np.arange(64) != 3                  # sample 3's null vector is arbitrary
    if n == 12:
        close(got.rvec[clean], np.asarray(want.rvec)[clean], atol=1e-5)
        close(got.tvec[clean], np.asarray(want.tvec)[clean], atol=1e-5)
        return
    # A minimal 6-point sample leaves the 12x12 normal matrix with a null
    # vector that f32 rounding dominates: the two frameworks land on other
    # vectors and the Gauss-Newton steps rescue most, not the same, samples.
    # Compare what RANSAC scores: how many hypotheses reproject all points.
    err = tgeo.reprojection_error(got, t(pts), t(uv), K_T).numpy()
    jerr = np.asarray(jax.jit(jax.vmap(
        lambda r, s: jgeo.reprojection_error(jgeo.Camera(r, s), jnp.asarray(pts),
                                             jnp.asarray(uv), K_J)))(want.rvec, want.tvec))
    good = (np.median(err, axis=1) < 0.5)[clean].mean()
    jgood = (np.median(jerr, axis=1) < 0.5)[clean].mean()
    assert good >= 0.7 and good >= jgood - 0.1, (good, jgood)


@pytest.mark.parametrize("solver", ["block", "lu"])
def test_refine_pose_matches_jax(rng, solver):
    pts = _scene(rng, 48)
    rvec = np.array([0.1, -0.2, 0.05], np.float32)
    tvec = np.array([0.3, -0.1, 0.4], np.float32)
    uv = np.asarray(J_PROJECT(jnp.asarray(pts), jnp.asarray(rvec), jnp.asarray(tvec))[0])
    w = rng.uniform(0.5, 1.0, 48).astype(np.float32)
    r0, t0 = rvec + 0.02, tvec - 0.03
    want = jax.jit(lambda cam, p, q, wt: jgeo.refine_pose(cam, p, q, K_J, wt, n_iters=4,
                                                          solver=solver))(
        jgeo.Camera(jnp.asarray(r0), jnp.asarray(t0)), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(w))
    got = tgeo.refine_pose(tgeo.Camera(t(r0), t(t0)), t(pts), t(uv), K_T, t(w),
                           n_iters=4, solver=solver)
    close(got.rvec, want.rvec, atol=1e-5)
    close(got.tvec, want.tvec, atol=1e-5)
    np.testing.assert_allclose(got.rvec.numpy(), rvec, atol=1e-4)
    np.testing.assert_allclose(got.tvec.numpy(), tvec, atol=1e-3)
    with pytest.raises(ValueError, match="solver"):
        tgeo.refine_pose(got, t(pts), t(uv), K_T, t(w), solver="qr")


def _ba_scene(rng, n_cams=4, n_pts=30):
    pts = _scene(rng, n_pts)
    rvecs = np.array([[0.0, 0.08 * (i - n_cams / 2), 1e-9 * i] for i in range(n_cams)],
                     np.float32)
    tvecs = np.array([[0.4 * (i - n_cams / 2), 0.0, 0.0] for i in range(n_cams)], np.float32)
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.concatenate([
        np.asarray(J_PROJECT(jnp.asarray(pts), jnp.asarray(rvecs[i]), jnp.asarray(tvecs[i]))[0])
        for i in range(n_cams)])
    uv = uv + rng.normal(size=uv.shape).astype(np.float32)
    valid = rng.random(n_cams * n_pts) > 0.2
    return pts, rvecs, tvecs, cam_idx, pt_idx, uv.astype(np.float32), valid


def test_jacobians_and_residuals_match_jax(rng):
    pts, rvecs, tvecs, cam_idx, pt_idx, uv, valid = _ba_scene(rng)
    jstate = jba.BAState(jnp.asarray(rvecs), jnp.asarray(tvecs), jnp.asarray(pts))
    jobs = jba.Observations(jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(uv),
                            jnp.asarray(valid))
    tstate = tba.BAState(t(rvecs), t(tvecs), t(pts))
    tobs = tba.Observations(t(cam_idx), t(pt_idx), t(uv), t(valid))
    assert int(tobs.count()) == int(valid.sum())
    # Pixel-scale quantities (focal 400 over depth ~5): atol 1e-3 on
    # Jacobian entries up to ~1e3, 1e-4 on residuals.
    for got, want in zip(tba._analytic_jacobians(tstate, tobs, K_T),
                         jax.jit(jba._analytic_jacobians)(jstate, jobs, K_J)):
        close(got, want, rtol=1e-5, atol=1e-3)
    # ... and against autodiff of the JAX residual, the JAX package's oracle.
    for got, want in zip(tba._analytic_jacobians(tstate, tobs, K_T),
                         jax.jit(jba._obs_jacobians)(jstate, jobs, K_J)):
        close(got, want, rtol=1e-3, atol=2e-2)
    close(tba.residuals(tstate, tobs, K_T), jax.jit(jba.residuals)(jstate, jobs, K_J), atol=1e-4)
    close(tba.rms_error(tstate, tobs, K_T), jax.jit(jba.rms_error)(jstate, jobs, K_J), atol=1e-5)


def test_jacobian_core_takes_leading_batch_axes(rng):
    pts, rvecs, tvecs, cam_idx, pt_idx, uv, valid = _ba_scene(rng)
    args = (t(rvecs)[cam_idx.astype(np.int64)], t(tvecs)[cam_idx.astype(np.int64)],
            t(pts)[pt_idx.astype(np.int64)], t(uv), t(valid))
    flat = tba._analytic_jacobians_core(*args, K_T)
    folded = tba._analytic_jacobians_core(*[a.view(4, 30, *a.shape[1:]) for a in args], K_T)
    for a, b in zip(flat, folded):
        assert torch.equal(a.view(b.shape), b)
