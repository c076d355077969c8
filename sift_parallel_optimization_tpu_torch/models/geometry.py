"""Multi-view geometry primitives (port of ``models/geometry.py``).

Closed-form batched linear algebra in fp32. Where the JAX package vmaps a
function over points or hypotheses, the port's functions take leading batch
axes (written ``...``) and broadcast, so a RANSAC over N hypotheses is one
call on (N, ...) tensors. The tiny-matrix primitives (adjugate inverses,
block inversion, inverse iteration, Newton polar factor) are elementwise
algebra and batched matmuls only: no LU loop and, apart from
:func:`decompose_essential`, no SVD.

Conventions: world-to-camera pose (R, t): x_cam = R @ x_world + t.
Pixels via intrinsics K (3x3, zero skew). Rotations stored as 3-vectors
(axis-angle, Rodrigues) wherever they are optimized, as matrices elsewhere.

Every product here is geometry: on the card it must run in full fp32
(``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default); the
functions that multiply refuse CUDA tensors under TF32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.core.pyramid_ref import check_fp32_matmul


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j) -> (..., i)."""
    return (m @ v[..., None])[..., 0]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def _nonzero(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x where |x| > eps, else eps (a safe divisor)."""
    return torch.where(x.abs() > eps, x, torch.full_like(x, eps))


# ---------------------------------------------------------------------------
# Batched small-matrix primitives
# ---------------------------------------------------------------------------


def smallest_eigvec(ata: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """(..., n, n) PSD -> (..., n) unit eigenvector of the smallest
    eigenvalue, via shifted inverse iteration.

    The matrix is first DIAGONALLY EQUILIBRATED (D a D with
    D = diag(ata)^-1/2): raw DLT normal matrices mix pixel^2 and unit^2
    scales across columns (condition ~1e10, beyond f32), while the
    equilibrated form is near-unit-diagonal -- and an exact null vector
    survives equilibration exactly (A D y = 0 <=> A (D y) = 0). The shift
    (1e-6 on the unit diagonal) keeps the inverse finite for degenerate
    inputs (a RANSAC sample of coplanar points), where the result is an
    arbitrary near-null vector that scores zero inliers. The inverse is
    formed once with :func:`_block_inv` and iterated with matvecs.
    """
    n = ata.shape[-1]
    diag = torch.diagonal(ata, dim1=-2, dim2=-1)
    d = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30))
    eq = ata * d[..., :, None] * d[..., None, :]
    shifted = eq + 1e-6 * torch.eye(n, dtype=ata.dtype, device=ata.device)
    # Deterministic generic start vector (not axis-aligned, so it is never
    # exactly orthogonal to the null vector of real inputs).
    v0 = torch.sin(torch.arange(1, n + 1, dtype=ata.dtype, device=ata.device))
    v = v0.expand(*ata.shape[:-2], n)
    inv = _block_inv(shifted)
    for _ in range(iters):
        v = _unit(_matvec(inv, v))
    return _unit(v * d)


def _inv2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 2x2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = _nonzero(a * d - b * c, 1e-30)
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / det[..., None, None]


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 determinant."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = _nonzero(a * A + b * D + c * G, 1e-30)
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)],
        -2,
    )
    return adj / det[..., None, None]


def _inv4(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 4x4 inverse (2x2-minor cofactor expansion)."""
    e = lambda r, c: m[..., r, c]
    s0 = e(0, 0) * e(1, 1) - e(1, 0) * e(0, 1)
    s1 = e(0, 0) * e(1, 2) - e(1, 0) * e(0, 2)
    s2 = e(0, 0) * e(1, 3) - e(1, 0) * e(0, 3)
    s3 = e(0, 1) * e(1, 2) - e(1, 1) * e(0, 2)
    s4 = e(0, 1) * e(1, 3) - e(1, 1) * e(0, 3)
    s5 = e(0, 2) * e(1, 3) - e(1, 2) * e(0, 3)
    c5 = e(2, 2) * e(3, 3) - e(3, 2) * e(2, 3)
    c4 = e(2, 1) * e(3, 3) - e(3, 1) * e(2, 3)
    c3 = e(2, 1) * e(3, 2) - e(3, 1) * e(2, 2)
    c2 = e(2, 0) * e(3, 3) - e(3, 0) * e(2, 3)
    c1 = e(2, 0) * e(3, 2) - e(3, 0) * e(2, 2)
    c0 = e(2, 0) * e(3, 1) - e(3, 0) * e(2, 1)
    det = _nonzero(s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0, 1e-30)
    inv = torch.stack([
        torch.stack([
            e(1, 1) * c5 - e(1, 2) * c4 + e(1, 3) * c3,
            -e(0, 1) * c5 + e(0, 2) * c4 - e(0, 3) * c3,
            e(3, 1) * s5 - e(3, 2) * s4 + e(3, 3) * s3,
            -e(2, 1) * s5 + e(2, 2) * s4 - e(2, 3) * s3,
        ], -1),
        torch.stack([
            -e(1, 0) * c5 + e(1, 2) * c2 - e(1, 3) * c1,
            e(0, 0) * c5 - e(0, 2) * c2 + e(0, 3) * c1,
            -e(3, 0) * s5 + e(3, 2) * s2 - e(3, 3) * s1,
            e(2, 0) * s5 - e(2, 2) * s2 + e(2, 3) * s1,
        ], -1),
        torch.stack([
            e(1, 0) * c4 - e(1, 1) * c2 + e(1, 3) * c0,
            -e(0, 0) * c4 + e(0, 1) * c2 - e(0, 3) * c0,
            e(3, 0) * s4 - e(3, 1) * s2 + e(3, 3) * s0,
            -e(2, 0) * s4 + e(2, 1) * s2 - e(2, 3) * s0,
        ], -1),
        torch.stack([
            -e(1, 0) * c3 + e(1, 1) * c1 - e(1, 2) * c0,
            e(0, 0) * c3 - e(0, 1) * c1 + e(0, 2) * c0,
            -e(3, 0) * s3 + e(3, 1) * s1 - e(3, 2) * s0,
            e(2, 0) * s3 - e(2, 1) * s1 + e(2, 2) * s0,
        ], -1),
    ], -2)
    return inv / det[..., None, None]


def _block_inv(m: torch.Tensor) -> torch.Tensor:
    """Batched n x n inverse by recursive 2x2 block elimination.

    Base cases are the closed-form 2/3/4 adjugate inverses; larger n
    splits into [[A, B], [C, D]] and uses the Schur complement
    S = D - C A^-1 B -- every step is elementwise algebra or a batched
    matmul, never a pivot loop. Intended for the WELL-SCALED matrices of
    this module's solvers -- callers equilibrate first (smallest_eigvec,
    _psd_solve), which keeps the leading blocks of a PSD input safely
    invertible in f32.
    """
    n = m.shape[-1]
    if n == 1:
        return 1.0 / _nonzero(m, 1e-30)
    if n == 2:
        return _inv2(m)
    if n == 3:
        return _inv3(m)
    if n == 4:
        return _inv4(m)
    h = n // 2
    a = m[..., :h, :h]
    b = m[..., :h, h:]
    c = m[..., h:, :h]
    d = m[..., h:, h:]
    ai = _block_inv(a)
    aib = ai @ b
    cai = c @ ai
    si = _block_inv(d - c @ aib)
    sicai = si @ cai
    top = torch.cat([ai + aib @ sicai, -(aib @ si)], dim=-1)
    bot = torch.cat([-sicai, si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _psd_solve(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched solve of a PSD system via equilibrated block inversion.

    h (..., n, n), rhs (..., n) -> (..., n). Diagonal equilibration tames
    mixed-unit normal matrices (pixels^2 vs radians^2) before the f32
    closed-form inversion; inv(h) = D inv(DhD) D. One step of iterative
    refinement, x += B(rhs - h x), follows the approximate solve: the
    unpivoted block inverse loses ~cond * eps accuracy on ill-conditioned
    pose Hessians (low-parallax minimal samples).
    """
    diag = torch.diagonal(h, dim1=-2, dim2=-1)
    d = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30))
    heq = h * d[..., :, None] * d[..., None, :]
    binv = _block_inv(heq)
    g = rhs * d
    x = _matvec(binv, g)
    resid = g - _matvec(heq, x)
    x = x + _matvec(binv, resid)
    return x * d


def polar_rotation(m: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Nearest rotation (orthogonal polar factor) of (..., 3, 3) with
    det > 0, via the Newton iteration X <- (X + X^-T) / 2 with determinant
    scaling -- closed-form 3x3 algebra only. Callers must pre-flip the sign
    so det(m) > 0 (pnp_dlt does)."""
    x = m
    for _ in range(iters):
        det = _det3(x).abs()
        x = x / torch.clamp(det, min=1e-30).pow(1.0 / 3.0)[..., None, None]
        x = 0.5 * (x + _inv3(x).transpose(-1, -2))
    return x


# ---------------------------------------------------------------------------
# Rotations (axis-angle <-> matrix)
# ---------------------------------------------------------------------------


def _hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]x."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
         torch.stack([-y, x, zero], -1)],
        -2,
    )


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix (exp map), with
    the first-order form I + hat(w) below 1e-6 rad."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)  # (..., 1)
    small = theta < 1e-6
    th = torch.where(small, torch.ones_like(theta), theta)
    K = _hat(w / th)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    R = eye + s * K + (1 - c) * (K @ K)
    return torch.where(small[..., None], eye + _hat(w), R)


def rotation_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (log map), robust at
    theta ~ pi.

    The standard v * theta / (2 sin theta) formula degenerates as
    theta -> pi (the antisymmetric part vanishes); there the axis is
    recovered from the dominant column of R + I instead.
    """
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        -1,
    )
    nv = torch.linalg.vector_norm(v, dim=-1)  # = 2 sin(theta), exact from the entries
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1) / 2, -1.0, 1.0)
    # atan2(|v|/2, cos) is well conditioned everywhere, unlike arccos whose
    # f32 error near +-1 gets amplified by theta/(2 sin theta).
    # |v / 2| is |v| / 2 bit for bit (halving is exact); it keeps a 0-d tensor
    # times a Python float out of torch.func.jacfwd, which promotes that to fp64.
    theta = torch.atan2(torch.linalg.vector_norm(v * 0.5, dim=-1), cos_t)
    # w = v * theta / |v|; as theta -> 0 the ratio -> 1/2 (continuous).
    ratio = torch.where(nv > 1e-6, theta / torch.clamp(nv, min=1e-12),
                        torch.full_like(nv, 0.5))
    w_general = v * ratio[..., None]
    # Near pi: R + I = 2 axis axis^T (+ O(pi - theta) error, so this branch
    # is kept NARROW; the two branches' errors meet at a gap of ~3e-4).
    B = R + torch.eye(3, dtype=R.dtype, device=R.device)
    k = torch.argmax(torch.diagonal(B, dim1=-2, dim2=-1), dim=-1)
    col = torch.gather(B, -1, k[..., None, None].expand(*B.shape[:-1], 1))[..., 0]
    axis = col / torch.clamp(torch.linalg.vector_norm(col, dim=-1, keepdim=True), min=1e-12)
    one = torch.ones_like(theta)
    sign = torch.where((axis * v).sum(-1) < 0, -one, one)
    w_pi = axis * (theta * sign)[..., None]
    return torch.where((theta > math.pi - 3e-4)[..., None], w_pi, w_general)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------


class Camera(NamedTuple):
    rvec: torch.Tensor  # (..., 3) axis-angle world->cam
    tvec: torch.Tensor  # (..., 3)

    def matrix(self, K: torch.Tensor) -> torch.Tensor:
        """(..., 3, 4) projection matrix P = K [R | t]."""
        return K @ torch.cat([rodrigues(self.rvec), self.tvec[..., :, None]], dim=-1)


def project(
    pts: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor, K: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N, 3) world pts under (..., 3) poses -> ((..., N, 2) pixels,
    (..., N) depth); points and poses broadcast over the leading axes. The
    residual function of every solver and every accuracy gate."""
    check_fp32_matmul(pts)
    R = rodrigues(rvec)
    pc = pts @ R.transpose(-1, -2) + tvec[..., None, :]
    z = pc[..., 2]
    uv1 = (pc / _nonzero(z, 1e-9)[..., None]) @ K.transpose(-1, -2)
    return uv1[..., :2], z


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------


def triangulate(
    P1: torch.Tensor, P2: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
) -> torch.Tensor:
    """Batched DLT triangulation: (..., 3, 4) x2 projections, (..., N, 2) x2
    pixels -> (..., N, 3) world points; the null vector of each
    correspondence's 4x4 normal matrix by inverse iteration (see
    :func:`smallest_eigvec`). Leading axes broadcast."""
    check_fp32_matmul(p1)
    rows = [
        u[..., c, None] * P[..., None, 2, :] - P[..., None, c, :]
        for P, u in ((P1, p1), (P2, p2)) for c in (0, 1)
    ]
    a = torch.stack(torch.broadcast_tensors(*rows), dim=-2)     # (..., N, 4, 4)
    x = smallest_eigvec(a.transpose(-1, -2) @ a)
    return x[..., :3] / _nonzero(x[..., 3:], 1e-12)


# ---------------------------------------------------------------------------
# Essential matrix & relative pose
# ---------------------------------------------------------------------------


def essential_from_fundamental(F: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    return K.transpose(-1, -2) @ F @ K


def decompose_essential(E: torch.Tensor):
    """E -> 4 candidate (R, t): (4, 3, 3) rotations, (4, 3) translations.
    The module's one SVD; its sign freedom is removed by the determinant
    fix-ups here and the cheirality vote of :func:`recover_pose`."""
    u, _, vt = torch.linalg.svd(E)
    # Ensure proper rotations.
    u = u * torch.sign(_det3(u))
    vt = vt * torch.sign(_det3(vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def recover_pose(
    E: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, K: torch.Tensor, mask: torch.Tensor
):
    """Pick the (R, t) candidate with the most points in front of BOTH
    cameras (cheirality check: all four triangulated in one batch). Camera 1
    is identity; returns (R, t, points3d, front_mask) for the winner. |t| = 1
    (monocular scale is unobservable)."""
    Rs, ts = decompose_essential(E)
    eye = torch.eye(3, 4, dtype=K.dtype, device=K.device)
    P1 = K @ eye
    P2 = K @ torch.cat([Rs, ts[:, :, None]], dim=-1)                 # (4, 3, 4)
    X = triangulate(P1, P2, p1, p2)                                  # (4, N, 3)
    z1 = X[..., 2]
    z2 = (X @ Rs.transpose(-1, -2) + ts[:, None, :])[..., 2]
    front = (z1 > 0) & (z2 > 0) & mask
    best = torch.argmax(front.sum(-1))
    return Rs[best], ts[best], X[best], front[best]


# ---------------------------------------------------------------------------
# PnP (camera from 2D-3D correspondences)
# ---------------------------------------------------------------------------


def pnp_dlt(
    pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor, w: torch.Tensor
) -> Camera:
    """Weighted DLT PnP: (..., N, 3) world, (..., N, 2) pixels, (..., N)
    weights -> Camera with (..., 3) fields.

    Solves for P (3x4) as the null vector of the weighted design matrix
    (inverse iteration, no SVD), then factors K^-1 P into [R|t] with the
    Newton polar factor. Weights make it RANSAC-friendly (outliers get
    w = 0) with static shapes; a leading axis is a batch of hypotheses.
    """
    check_fp32_matmul(pts3d)
    x = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], -1)     # (..., N, 4)
    u, v = pts2d[..., 0:1], pts2d[..., 1:2]
    z = torch.zeros_like(x)
    rows_u = torch.cat([x, z, -u * x], -1)                          # (..., N, 12)
    rows_v = torch.cat([z, x, -v * x], -1)
    a = torch.cat([rows_u, rows_v], -2)                             # (..., 2N, 12)
    ww = torch.cat([w, w], -1)
    ata = a.transpose(-1, -2) @ (a * ww[..., None])
    P = smallest_eigvec(ata).reshape(*ata.shape[:-2], 3, 4)
    k_inv = _inv3(K)
    M = k_inv @ P[..., :3]
    # The null vector's sign is arbitrary: normalize so M = s*R with s > 0
    # (det(M) = s^3), which also settles cheirality for points in front.
    sgn = torch.sign(_det3(M))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)[..., None, None]
    P = P * sgn
    M = M * sgn
    R = polar_rotation(M)
    scale = (R * M).sum((-1, -2)) / 3.0                             # trace(R^T M) / 3
    t = _matvec(k_inv, P[..., 3]) / _nonzero(scale, 1e-12)[..., None]
    cam = Camera(rvec=rotation_log(R), tvec=t)
    return refine_pose(cam, pts3d, pts2d, K, w, n_iters=3)


def refine_pose(
    cam: Camera,
    pts3d: torch.Tensor,
    pts2d: torch.Tensor,
    K: torch.Tensor,
    w: torch.Tensor,
    n_iters: int = 3,
    damping: float = 1e-6,
    solver: str = "block",
) -> Camera:
    """Gauss-Newton pose-only refinement (weighted reprojection) of (..., 3)
    poses against (..., N, 3) / (..., N, 2) / (..., N) points, pixels and
    weights.

    Linearizes with the closed-form camera Jacobian of ``models/ba``.
    ``solver`` picks the 6x6 normal solve: "block" (equilibrated block
    inverse, the form for a batch of RANSAC hypotheses) or "lu"
    (``torch.linalg.solve_ex``: a singular system gives a non-finite pose
    instead of raising).
    """
    from sift_parallel_optimization_tpu_torch.models.ba import _analytic_jacobians_core

    if solver not in ("block", "lu"):
        raise ValueError(f"solver must be 'block' or 'lu', got {solver!r}")
    theta = torch.cat([cam.rvec, cam.tvec], dim=-1)
    shape = torch.broadcast_shapes(theta.shape[:-1], pts3d.shape[:-2])
    theta = theta.expand(*shape, 6)
    n = pts3d.shape[-2]
    valid = torch.ones((*shape, n), dtype=torch.bool, device=pts3d.device)
    eye = damping * torch.eye(6, dtype=theta.dtype, device=theta.device)
    for _ in range(n_iters):
        jc, _jp, r = _analytic_jacobians_core(
            theta[..., None, :3].expand(*shape, n, 3),
            theta[..., None, 3:].expand(*shape, n, 3),
            pts3d, pts2d, valid, K,
        )
        # Residuals are weighted by w BEFORE squaring (res * w), i.e. normal
        # equations in w^2 -- the JAX package's contract.
        jc = jc * w[..., None, None]
        r = r * w[..., None]
        jflat = jc.reshape(*shape, 2 * n, 6)
        h = jflat.transpose(-1, -2) @ jflat + eye
        g = _matvec(jflat.transpose(-1, -2), r.reshape(*shape, 2 * n))
        if solver == "lu":
            step = torch.linalg.solve_ex(h, g[..., None], check_errors=False).result[..., 0]
        else:
            step = _psd_solve(h, g)
        theta = theta - step
    return Camera(rvec=theta[..., :3], tvec=theta[..., 3:])


def reprojection_error(
    cam: Camera, pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor
) -> torch.Tensor:
    """(..., N) pixel reprojection distances."""
    uv, _ = project(pts3d, cam.rvec, cam.tvec, K)
    return torch.linalg.vector_norm(uv - pts2d, dim=-1)
