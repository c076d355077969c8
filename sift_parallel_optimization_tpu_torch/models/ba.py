"""Bundle-adjustment containers, residuals and closed-form Jacobians (port
of the first part of ``models/ba.py``).

Ported so far: the fixed-capacity ``Observations`` / ``BAState`` containers
the SfM map is built from, the reprojection residuals, and the analytic
per-observation Jacobians that ``geometry.refine_pose`` (and so every PnP)
linearizes with. The normal-equation assembly, the Schur and CG solvers and
the ``bundle_adjust`` loops are not ported yet.

The Jacobians are written on component tensors (one tensor per matrix
entry, all of one shape ``(...)``), as the JAX package writes them: every
step is elementwise, so any leading batch axes -- observations, RANSAC
hypotheses -- pass straight through.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.models.geometry import project


class Observations(NamedTuple):
    """Fixed-capacity observation list (the BA 'measurement graph')."""

    cam_idx: torch.Tensor  # (M,) int32
    pt_idx: torch.Tensor   # (M,) int32
    uv: torch.Tensor       # (M, 2) f32 measured pixels
    valid: torch.Tensor    # (M,) bool

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


class BAState(NamedTuple):
    rvecs: torch.Tensor   # (C, 3) axis-angle world->cam
    tvecs: torch.Tensor   # (C, 3)
    points: torch.Tensor  # (P, 3)


def residuals(state: BAState, obs: Observations, K: torch.Tensor) -> torch.Tensor:
    """(M, 2) reprojection residuals, zeroed on invalid slots."""
    cam, pt = obs.cam_idx.long(), obs.pt_idx.long()
    uv, _ = project(state.points[pt][:, None, :], state.rvecs[cam], state.tvecs[cam], K)
    return torch.where(obs.valid[:, None], uv[:, 0] - obs.uv, 0.0)


def rms_error(state: BAState, obs: Observations, K: torch.Tensor) -> torch.Tensor:
    r = residuals(state, obs, K)
    return torch.sqrt((r * r).sum() / torch.clamp(obs.count(), min=1))


def _hat_cols(x, y, z):
    """Cross-product matrix [v]x as a 3x3 nested list of component tensors."""
    zero = torch.zeros_like(x)
    return [[zero, -z, y], [z, zero, -x], [-y, x, zero]]


def _mat3_mul_cols(a, b):
    """3x3 matrix product on nested lists of component tensors."""
    return [
        [sum(a[i][l] * b[l][j] for l in range(3)) for j in range(3)]
        for i in range(3)
    ]


def _rodrigues_cols(wx, wy, wz):
    """``geometry.rodrigues`` on components: the 9 entries of R, with the
    same first-order branch (R ~ I + hat(w)) below 1e-6 rad."""
    nsq = wx * wx + wy * wy + wz * wz
    theta = torch.sqrt(nsq)
    small = theta < 1e-6
    th = torch.where(small, torch.ones_like(theta), theta)
    kx, ky, kz = wx / th, wy / th, wz / th
    s = torch.sin(theta)
    mc = 1.0 - torch.cos(theta)
    c = torch.cos(theta)
    # R = cos(t) I + sin(t) [k]x + (1-cos(t)) k k^T  (unit axis k).
    big = [
        [c + mc * kx * kx, -s * kz + mc * kx * ky, s * ky + mc * kx * kz],
        [s * kz + mc * kx * ky, c + mc * ky * ky, -s * kx + mc * ky * kz],
        [-s * ky + mc * kx * kz, s * kx + mc * ky * kz, c + mc * kz * kz],
    ]
    one = torch.ones_like(wx)
    lin = [[one, -wz, wy], [wz, one, -wx], [-wy, wx, one]]
    return [
        [torch.where(small, lin[i][j], big[i][j]) for j in range(3)]
        for i in range(3)
    ]


def _rotation_point_jac_cols(w_cols, p_cols, R):
    """d(R(w) p)/dw, closed form (Gallego & Yezzi 2015, eq. 9), on
    components. As ||w|| -> 0 the limit is -[p]x, substituted below the
    epsilon (matches the first-order branch of rodrigues)."""
    wx, wy, wz = w_cols
    nsq = wx * wx + wy * wy + wz * wz
    h = _hat_cols(wx, wy, wz)
    ph = _hat_cols(*p_cols)
    w_ = [wx, wy, wz]
    # inner = w w^T + R^T [w]x - [w]x
    inner = [
        [
            w_[i] * w_[j] + sum(R[l][i] * h[l][j] for l in range(3)) - h[i][j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    b = _mat3_mul_cols(ph, inner)
    rb = _mat3_mul_cols(R, b)
    inv = 1.0 / torch.clamp(nsq, min=1e-12)
    small = nsq < 1e-12
    return [
        [torch.where(small, -ph[i][j], -rb[i][j] * inv) for j in range(3)]
        for i in range(3)
    ]


def _analytic_jacobian_cols(rv_cols, tv_cols, p_cols, uv_cols, valid, K):
    """Closed-form Jacobians on component tensors. Returns (jc [2][6],
    jp [2][3], r [2]) nested lists, zeroed on invalid slots.

    Chain: r = pi(q) - uv with q = R p + t, so
      d r / d t = A,  d r / d p = A R,  d r / d w = A * d(R p)/dw
    with A = d pi / d q the (2, 3) pinhole Jacobian (rows [fx/z, 0,
    -fx x/z^2], [0, fy/z, -fy y/z^2] -- the zeros make A-products sparse).
    """
    R = _rodrigues_cols(*rv_cols)
    q = [
        sum(R[i][j] * p_cols[j] for j in range(3)) + tv_cols[i]
        for i in range(3)
    ]
    z = q[2]
    zs = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    fx, fy = K[0, 0], K[1, 1]
    inv_z = 1.0 / zs
    zero = torch.zeros_like(z)
    a00 = fx * inv_z
    a02 = -fx * q[0] * inv_z * inv_z
    a11 = fy * inv_z
    a12 = -fy * q[1] * inv_z * inv_z
    # jp = A R; row sparsity of A gives two products per entry.
    jp0 = [a00 * R[0][k] + a02 * R[2][k] for k in range(3)]
    jp1 = [a11 * R[1][k] + a12 * R[2][k] for k in range(3)]
    dw = _rotation_point_jac_cols(rv_cols, p_cols, R)
    jw0 = [a00 * dw[0][k] + a02 * dw[2][k] for k in range(3)]
    jw1 = [a11 * dw[1][k] + a12 * dw[2][k] for k in range(3)]
    # jc = [jw | jt] with jt = A.
    jc0 = jw0 + [a00, zero, a02]
    jc1 = jw1 + [zero, a11, a12]
    r0 = q[0] * inv_z * fx + K[0, 2] - uv_cols[0]
    r1 = q[1] * inv_z * fy + K[1, 2] - uv_cols[1]
    v = valid.to(torch.float32)
    jc = [[e * v for e in jc0], [e * v for e in jc1]]
    jp = [[e * v for e in jp0], [e * v for e in jp1]]
    r = [r0 * v, r1 * v]
    return jc, jp, r


def _analytic_jacobians_core(rv, tv, p, uv, valid, K: torch.Tensor):
    """Closed-form Jacobians from pre-gathered per-slot inputs.

    rv/tv/p: (..., 3); uv: (..., 2); valid: (...) bool, all broadcastable
    to one leading shape. Returns (jc (..., 2, 6), jp (..., 2, 3),
    r (..., 2)), zeroed on invalid slots.
    """
    cols = lambda t, n: tuple(t[..., i] for i in range(n))
    jc_c, jp_c, r_c = _analytic_jacobian_cols(
        cols(rv, 3), cols(tv, 3), cols(p, 3), cols(uv, 2), valid, K
    )
    jc = torch.stack([torch.stack(row, -1) for row in jc_c], -2)
    jp = torch.stack([torch.stack(row, -1) for row in jp_c], -2)
    r = torch.stack(r_c, -1)
    return jc, jp, r


def _analytic_jacobians(state: BAState, obs: Observations, K: torch.Tensor):
    """Closed-form per-observation Jacobians: Jc (M, 2, 6), Jp (M, 2, 3),
    r (M, 2), zeroed on invalid slots."""
    cam, pt = obs.cam_idx.long(), obs.pt_idx.long()
    return _analytic_jacobians_core(
        state.rvecs[cam], state.tvecs[cam], state.points[pt], obs.uv, obs.valid, K
    )
