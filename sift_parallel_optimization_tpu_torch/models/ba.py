"""Gauss-Newton bundle adjustment with Schur-complement elimination (port of
``models/ba.py``).

* Observations live in a FIXED-capacity structure-of-arrays with a valid
  mask (invalid slots contribute zero residual/Jacobian) -- static shapes.
* Per-observation 2x6 / 2x3 Jacobians are closed form (``geometry.
  refine_pose`` and so every PnP linearizes with them too). They are written
  on component tensors (one tensor per matrix entry), as the JAX package
  writes them: every step is elementwise, so any leading batch axes --
  observations, RANSAC hypotheses, point-grouped slots -- pass through.
* Two solvers of the reduced camera system. "dense" assembles the normal
  blocks with a DENSE (C, P, 6, 3) camera-point cross block and solves the
  (6C, 6C) Schur complement with one LU; "cg" keeps the observations in a
  point-grouped layout (:class:`GroupPlan`) and runs block-Jacobi
  preconditioned CG on the Schur complement without ever forming it.
  ``resolve_solver`` picks between them from the static capacities.
* Per-camera and per-point sums are one-hot matrix products where the JAX
  package has them: deterministic on the card (a float ``index_add_`` sums
  in atomic order), and exact, the one-hot factors being {0, 1}.

The loops are Python loops with fixed trip counts. Where the JAX package
stops a ``lax.while_loop`` on a value (CG's residual, LM's accept test), the
port runs every trip and gates each update with ``torch.where`` on that
value: a finished iteration changes nothing, and the host never waits on the
device inside a solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.models.geometry import project
from sift_parallel_optimization_tpu_torch.utils.convert import tuple_from_numpy, tuple_to_numpy
from sift_parallel_optimization_tpu_torch.utils.device import f32_precision, resolve_device


class Observations(NamedTuple):
    """Fixed-capacity observation list (the BA 'measurement graph')."""

    cam_idx: torch.Tensor  # (M,) int32
    pt_idx: torch.Tensor   # (M,) int32
    uv: torch.Tensor       # (M, 2) f32 measured pixels
    valid: torch.Tensor    # (M,) bool

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


class Anchors(NamedTuple):
    """Fixed-landmark reprojection factors: camera DOF only.

    The windowed odometry keeps an observation of an evicted landmark alive
    against the landmark's FROZEN world position: the residual is
    project(pose_cam, xyz_frozen) - uv with a Jacobian only in the 6 camera
    DOF, so anchors contribute ONLY to the Hcc diagonal blocks and the camera
    rhs -- the Schur structure (and both solvers' shapes) are untouched.
    """

    cam_idx: torch.Tensor  # (A,) int32
    xyz: torch.Tensor      # (A, 3) f32 frozen world positions (constants)
    uv: torch.Tensor       # (A, 2) f32 measured pixels
    valid: torch.Tensor    # (A,) bool

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


def empty_anchors(capacity: int, device=None) -> Anchors:
    """All-invalid anchors on ``device`` (None means the card, and raises
    without one)."""
    device = resolve_device(device)
    return Anchors(
        cam_idx=torch.zeros(capacity, dtype=torch.int32, device=device),
        xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        uv=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def anchors_from_numpy(arrays, device=None) -> Anchors:
    """Anchors from numpy arrays (``utils/convert.tuple_from_numpy``: e.g. the
    JAX package's anchors). ``device`` None means the card, and raises
    without one."""
    return tuple_from_numpy(Anchors, arrays, {"cam_idx": torch.int32, "valid": torch.bool},
                            device)


anchors_to_numpy = tuple_to_numpy


class BAState(NamedTuple):
    rvecs: torch.Tensor   # (C, 3) axis-angle world->cam
    tvecs: torch.Tensor   # (C, 3)
    points: torch.Tensor  # (P, 3)


def residuals(state: BAState, obs: Observations, K: torch.Tensor) -> torch.Tensor:
    """(M, 2) reprojection residuals, zeroed on invalid slots."""
    cam, pt = obs.cam_idx.long(), obs.pt_idx.long()
    uv, _ = project(state.points[pt][:, None, :], state.rvecs[cam], state.tvecs[cam], K)
    return torch.where(obs.valid[:, None], uv[:, 0] - obs.uv, 0.0)


def anchor_residuals(state: BAState, anchors: Anchors, K: torch.Tensor) -> torch.Tensor:
    """(A, 2) fixed-landmark reprojection residuals, zeroed on invalid slots.
    The landmark position is the anchor's FROZEN constant, so the residual
    depends only on the camera pose (see :class:`Anchors`)."""
    cam = anchors.cam_idx.long()
    uv, _ = project(anchors.xyz[:, None, :], state.rvecs[cam], state.tvecs[cam], K)
    return torch.where(anchors.valid[:, None], uv[:, 0] - anchors.uv, 0.0)


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


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """(M,) IRLS weights for the Huber loss on residual norms."""
    n = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(n <= delta, 1.0, delta / torch.clamp(n, min=1e-12))


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """(..., n) one-hot rows, zero where ``idx`` is outside [0, n) -- as
    ``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` raises there)."""
    return (idx[..., None].long() == torch.arange(n, device=idx.device)).to(dtype)


# ---------------------------------------------------------------------------
# Dense Schur complement
# ---------------------------------------------------------------------------


class NormalBlocks(NamedTuple):
    """Assembled normal-equation blocks (the distributable intermediate: the
    sum over observations commutes with everything downstream)."""

    hcc: torch.Tensor  # (C, 6, 6) camera diagonal blocks
    hpp: torch.Tensor  # (P, 3, 3) point diagonal blocks
    bc: torch.Tensor   # (C, 6)
    bp: torch.Tensor   # (P, 3)
    w: torch.Tensor    # (C, P, 6, 3) camera-point cross blocks


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, i, k) x (M, i, l) -> (M, k, l): per-row J^T J."""
    return a.transpose(-1, -2) @ b


def _jtr(j: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(M, i, k) x (M, i) -> (M, k): per-row J^T r."""
    return (j * r[..., None]).sum(-2)


@f32_precision
def assemble_normal_blocks(
    state: BAState,
    obs: Observations,
    K: torch.Tensor,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    anchors: Anchors | None = None,
) -> NormalBlocks:
    """Linearize all observations (and anchors) and reduce them into block
    form. Anchor rows ride the camera-side sums only."""
    C = state.rvecs.shape[0]
    P = state.points.shape[0]
    M = obs.cam_idx.shape[0]
    if anchors is None:
        jc_all, jp, r_all = _analytic_jacobians(state, obs, K)
        cam_all = obs.cam_idx
    else:
        # One linearization pass over observations + anchor factors; the
        # anchor rows' point Jacobians are computed and sliced away.
        cam_all = torch.cat([obs.cam_idx, anchors.cam_idx])
        cam = cam_all.long()
        jc_all, jp_all, r_all = _analytic_jacobians_core(
            state.rvecs[cam], state.tvecs[cam],
            torch.cat([state.points[obs.pt_idx.long()], anchors.xyz]),
            torch.cat([obs.uv, anchors.uv]),
            torch.cat([obs.valid, anchors.valid]),
            K,
        )
        jp = jp_all[:M]
    if huber_delta is not None:
        hw_all = torch.sqrt(_huber_weights(r_all, huber_delta))
        jc_all = jc_all * hw_all[:, None, None]
        r_all = r_all * hw_all[:, None]
        jp = jp * hw_all[:M, None, None]
    # Gauge fixing: freeze camera 0 (zero its Jacobian).
    if fix_first_cam:
        jc_all = jc_all * (cam_all != 0)[:, None, None].to(jc_all.dtype)
    jc, r = jc_all[:M], r_all[:M]

    # Sums over observations as one-hot products (camera side over the
    # concatenated obs + anchor rows).
    oh_ca = _one_hot(cam_all, C)                    # (M+A, C)
    oh_p = _one_hot(obs.pt_idx, P)                  # (M, P)
    hcc = (oh_ca.T @ _gram(jc_all, jc_all).reshape(-1, 36)).reshape(C, 6, 6)
    hpp = (oh_p.T @ _gram(jp, jp).reshape(M, 9)).reshape(P, 3, 3)
    bc = -(oh_ca.T @ _jtr(jc_all, r_all))
    bp = -(oh_p.T @ _jtr(jp, r))
    # Dense camera-point cross blocks W[c, p] = sum_obs Jc^T Jp, a two-sided
    # one-hot contraction: (C*18, M) x (M, P).
    w_obs = _gram(jc, jp).reshape(M, 1, 18)         # (M, 1, 18)
    t = (oh_ca[:M, :, None] * w_obs).reshape(M, C * 18)
    w = (t.T @ oh_p).reshape(C, 18, P).permute(0, 2, 1).reshape(C, P, 6, 3)
    return NormalBlocks(hcc=hcc, hpp=hpp, bc=bc, bp=bp, w=w)


def _damp_blocks(h: torch.Tensor, damping) -> torch.Tensor:
    """Marquardt-scaled damping: lambda * diag(H) + an absolute floor.

    Pure identity damping leaves the monocular scale-gauge direction of the
    reduced system near-singular relative to the ~1e6-magnitude reprojection
    blocks, which overwhelms a float32 solve; scaling by the diagonal bounds
    the condition number by ~1/damping. ``damping`` may be a 0-d tensor (LM).
    """
    d = torch.diagonal(h, dim1=-2, dim2=-1)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    return h + (damping * d + 1e-6)[..., None] * eye


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse; the determinant is floored
    at 1e-20 in magnitude, as in the JAX package."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = c * h - b * i
    cc = b * f - c * e
    cd = f * g - d * i
    ce = a * i - c * g
    cf = c * d - a * f
    cg = d * h - e * g
    ch = b * g - a * h
    ci = a * e - b * d
    det = a * ca + b * cd + c * cg
    inv = torch.stack(
        [torch.stack([ca, cb, cc], -1), torch.stack([cd, ce, cf], -1),
         torch.stack([cg, ch, ci], -1)],
        -2,
    )
    det = torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    return inv / det[..., None, None]


def _solve_dense(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x = b that never raises: a singular system gives inf/nan, as
    ``jnp.linalg.solve`` does, where ``torch.linalg.solve`` would raise."""
    return torch.linalg.solve_ex(a, b[..., None], check_errors=False).result[..., 0]


@f32_precision
def solve_schur(
    blocks: NormalBlocks,
    damping: float = 1e-3,
    fix_first_cam: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Schur-complement solve of the block system -> (delta_c, delta_p)."""
    hcc, hpp, bc, bp, w = blocks
    C, P = w.shape[0], w.shape[1]
    hcc = _damp_blocks(hcc, damping)
    hpp_inv = _inv3x3(_damp_blocks(hpp, damping))                   # (P, 3, 3)
    y = torch.einsum("cpik,pkl->cpil", w, hpp_inv)                  # (C, P, 6, 3)
    # Reduced camera system S = Hcc - Y W^T in the (6C, 6C) layout directly.
    s = -(y.permute(0, 2, 1, 3).reshape(6 * C, 3 * P)
          @ w.permute(0, 2, 1, 3).reshape(6 * C, 3 * P).T)
    s4 = s.view(C, 6, C, 6)
    cams = torch.arange(C, device=s.device)
    s4[cams, :, cams, :] += hcc
    b = bc - torch.einsum("cpik,pk->ci", y, bp)                     # (C, 6)
    if fix_first_cam:
        # Freeze camera 0 rows/cols via an identity block.
        m0 = torch.ones(6 * C, dtype=s.dtype, device=s.device)
        m0[:6] = 0.0
        s = s * m0[:, None] * m0[None, :] + torch.diag(1.0 - m0)
        b = torch.cat([torch.zeros_like(b[:1]), b[1:]])
    delta_c = _solve_dense(s, b.reshape(-1)).reshape(C, 6)
    # Back-substitution for landmarks.
    wt_dc = torch.einsum("cpik,ci->pk", w, delta_c)                 # (P, 3)
    delta_p = (hpp_inv @ (bp - wt_dc)[..., None])[..., 0]
    return delta_c, delta_p


# ---------------------------------------------------------------------------
# Implicit-Schur CG (the scalable path: no dense (C, P, 6, 3) cross block)
# ---------------------------------------------------------------------------


class GroupPlan(NamedTuple):
    """Point-grouped observation layout, computed ONCE per (obs, shapes).

    The grouping depends only on the observation INDEX structure, which is
    constant across Gauss-Newton iterations, so the layout work (ranking,
    scatters) is hoisted out of the GN loop. The camera assignment is carried
    as a one-hot tensor, which turns both W^T x and W y into dense products.

    Observations whose within-point rank reaches the capacity R are dropped
    (W stays exactly symmetric since there is only one grouping);
    ``n_dropped`` counts them -- size R accordingly.
    """

    perm: torch.Tensor       # (P, R) int32 source obs index per slot; M = pad
    cam_oh: torch.Tensor     # (P, R, C) f32 one-hot camera (0-rows on pad)
    uv: torch.Tensor         # (P, R, 2) grouped pixel observations
    valid: torch.Tensor      # (P, R) slot validity
    n_dropped: torch.Tensor  # () valid observations that overflowed R


class ImplicitBlocks(NamedTuple):
    """Per-GN-step linearization in the GroupPlan layout: O(M) memory, no
    O(C*P) dense cross block. S = Hcc - W Hpp^-1 W^T is only applied."""

    jc: torch.Tensor       # (P, R, 2, 6) point-grouped camera Jacobians
    jp: torch.Tensor       # (P, R, 2, 3) point-grouped point Jacobians
    cam_oh: torch.Tensor   # (P, R, C) from the plan
    hcc: torch.Tensor      # (C, 6, 6) DAMPED camera diagonal blocks
    hpp_inv: torch.Tensor  # (P, 3, 3) inverse damped point diagonal blocks
    bc: torch.Tensor       # (C, 6)
    bp: torch.Tensor       # (P, 3)


def _linearize(state, obs, K, huber_delta, fix_first_cam):
    """Masked, robust-weighted, gauge-fixed per-obs Jacobians + residuals."""
    jc, jp, r = _analytic_jacobians(state, obs, K)
    if huber_delta is not None:
        hw = torch.sqrt(_huber_weights(r, huber_delta))
        jc = jc * hw[:, None, None]
        jp = jp * hw[:, None, None]
        r = r * hw[:, None]
    if fix_first_cam:
        jc = jc * (obs.cam_idx != 0)[:, None, None].to(jc.dtype)
    return jc, jp, r


def _group_rank(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(M,) group indices in [0, n] -> (M,) 0-based rank within each group
    (group n, the overflow group of invalid rows, ranked too)."""
    m = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    start = torch.searchsorted(sorted_idx, torch.arange(n + 1, dtype=idx.dtype,
                                                        device=idx.device))
    rank_sorted = torch.arange(m, device=idx.device) - start[sorted_idx.long()]
    rank = torch.empty(m, dtype=torch.int32, device=idx.device)
    rank[order] = rank_sorted.to(torch.int32)
    return rank


def _cg_capacity(n_obs: int, P: int, max_obs_per_point: int | None) -> int:
    """Static group capacity R with a 2x-mean heuristic."""

    def up8(v):
        return max(8, (v + 7) // 8 * 8)

    return max_obs_per_point or min(up8(2 * -(-n_obs // P)), up8(n_obs))


def make_group_plan(
    obs: Observations,
    n_cams: int,
    n_points: int,
    max_obs_per_point: int | None = None,
) -> GroupPlan:
    """Build the point-grouped layout for a fixed observation structure.

    Capacity defaults to 2x the mean occupancy (rounded up to 8); pass an
    explicit ``max_obs_per_point`` when the distribution is skewed. Invalid
    (padding) observations are routed to a virtual overflow group so they
    cannot eat a real group's rank capacity. Every rejected write goes to a
    spare slot past the end, which is then sliced off.
    """
    C, P = n_cams, n_points
    M = obs.cam_idx.shape[0]
    dev = obs.cam_idx.device
    R = _cg_capacity(M, P, max_obs_per_point)
    pt = obs.pt_idx.long()
    idx = torch.where(obs.valid, pt, P)
    rank = _group_rank(idx, P)
    keep = (rank < R) & obs.valid
    slot = torch.where(keep, pt * R + rank, P * R)
    perm = torch.full((P * R + 1,), M, dtype=torch.int32, device=dev)
    perm[slot] = torch.arange(M, dtype=torch.int32, device=dev)
    perm = perm[: P * R].reshape(P, R)
    slot_valid = perm < M
    src = torch.clamp(perm, max=M).long()
    cam_ext = torch.cat([obs.cam_idx, torch.zeros(1, dtype=obs.cam_idx.dtype, device=dev)])
    cam = torch.where(slot_valid, cam_ext[src], C)
    uv_ext = torch.cat([obs.uv, torch.zeros((1, 2), dtype=obs.uv.dtype, device=dev)])
    return GroupPlan(
        perm=perm, cam_oh=_one_hot(cam, C), uv=uv_ext[src], valid=slot_valid,
        n_dropped=obs.valid.sum() - keep.sum(),
    )


@f32_precision
def assemble_implicit_blocks(
    state: BAState,
    obs: Observations,
    K: torch.Tensor,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    max_obs_per_point: int | None = None,
    plan: GroupPlan | None = None,
    anchors: Anchors | None = None,
) -> ImplicitBlocks:
    """Linearize with the closed-form Jacobians DIRECTLY in the GroupPlan
    layout. Pass ``plan`` (from make_group_plan) when solving repeatedly over
    the same observation structure -- bundle_adjust does -- so the layout work
    runs once. Per step there are no gathers or scatters: camera parameters
    reach their slots through the one-hot product, the point broadcasts
    along its own group axis, and the camera-side sums are one product
    against the one-hot assignment."""
    C = state.rvecs.shape[0]
    P = state.points.shape[0]
    if plan is None:
        plan = make_group_plan(obs, C, P, max_obs_per_point)
    oh = plan.cam_oh
    R_cap = plan.perm.shape[1]
    n_slots = P * R_cap

    oh_flat = oh.reshape(n_slots, C)
    par_g = oh_flat @ torch.cat([state.rvecs, state.tvecs], dim=1)      # (n, 6)
    p_g = state.points[:, None, :].expand(P, R_cap, 3).reshape(n_slots, 3)
    uv_g = plan.uv.reshape(n_slots, 2)
    jc, jp, r = _analytic_jacobian_cols(
        (par_g[:, 0], par_g[:, 1], par_g[:, 2]),
        (par_g[:, 3], par_g[:, 4], par_g[:, 5]),
        (p_g[:, 0], p_g[:, 1], p_g[:, 2]),
        (uv_g[:, 0], uv_g[:, 1]),
        plan.valid.reshape(n_slots),
        K,
    )
    if huber_delta is not None:
        n = torch.sqrt(r[0] * r[0] + r[1] * r[1])
        hw = torch.sqrt(torch.where(n <= huber_delta, 1.0,
                                    huber_delta / torch.clamp(n, min=1e-12)))
        jc = [[e * hw for e in row] for row in jc]
        jp = [[e * hw for e in row] for row in jp]
        r = [e * hw for e in r]
    if fix_first_cam:
        keep = 1.0 - oh_flat[:, 0]
        jc = [[e * keep for e in row] for row in jc]

    # Camera-side reduction: the 36 J^T J entries and 6 J^T r entries per slot
    # (elementwise), summed per camera by ONE (C, n) x (n, 42) product.
    cam_cols = [
        jc[0][k] * jc[0][l] + jc[1][k] * jc[1][l] for k in range(6) for l in range(6)
    ] + [jc[0][k] * r[0] + jc[1][k] * r[1] for k in range(6)]
    out = oh_flat.T @ torch.stack(cam_cols, dim=-1)                     # (C, 42)
    hcc = out[:, :36].reshape(C, 6, 6)
    bc = -out[:, 36:42]

    # Point-side reduction: plain sums over the group axis.
    def psum_col(e):
        return e.reshape(P, R_cap).sum(dim=1)

    hpp = torch.stack([
        torch.stack([psum_col(jp[0][k] * jp[0][l] + jp[1][k] * jp[1][l]) for l in range(3)], -1)
        for k in range(3)
    ], -2)                                                              # (P, 3, 3)
    bp = -torch.stack([psum_col(jp[0][k] * r[0] + jp[1][k] * r[1]) for k in range(3)], -1)
    jc_g = torch.stack([torch.stack(row, -1) for row in jc], -2).reshape(P, R_cap, 2, 6)
    jp_g = torch.stack([torch.stack(row, -1) for row in jp], -2).reshape(P, R_cap, 2, 3)

    if anchors is not None:
        # Fixed-landmark anchor factors: camera DOF only, folded into hcc/bc
        # BEFORE damping, so the CG operator picks them up unchanged.
        cam = anchors.cam_idx.long()
        ja, _jp_a, ra = _analytic_jacobians_core(
            state.rvecs[cam], state.tvecs[cam], anchors.xyz, anchors.uv, anchors.valid, K)
        if huber_delta is not None:
            hwa = torch.sqrt(_huber_weights(ra, huber_delta))
            ja = ja * hwa[:, None, None]
            ra = ra * hwa[:, None]
        if fix_first_cam:
            ja = ja * (anchors.cam_idx != 0)[:, None, None].to(ja.dtype)
        oh_a = _one_hot(anchors.cam_idx, C)
        hcc = hcc + (oh_a.T @ _gram(ja, ja).reshape(-1, 36)).reshape(C, 6, 6)
        bc = bc - oh_a.T @ _jtr(ja, ra)

    hcc = _damp_blocks(hcc, damping)
    if fix_first_cam:
        # Row/col 0 of the reduced system is the identity (x0 stays 0).
        hcc = torch.cat([torch.eye(6, dtype=hcc.dtype, device=hcc.device)[None], hcc[1:]])
    hpp_inv = _inv3x3(_damp_blocks(hpp, damping))
    return ImplicitBlocks(jc=jc_g, jp=jp_g, cam_oh=oh, hcc=hcc, hpp_inv=hpp_inv, bc=bc, bp=bp)


# The CG operator's small per-slot products (2x6 by 6, 3x3 by 3, ...) are
# broadcast products and sums: as batched matmuls they become one tiny GEMV
# per slot batch, which took two thirds of a BA step's device time on the
# H100 (PERF.md, PR 5).


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j) -> (..., i), as a broadcast product and sum."""
    return (m * v[..., None, :]).sum(-1)


def _wt_apply(blk: ImplicitBlocks, x: torch.Tensor) -> torch.Tensor:
    """W^T x: (C, 6) camera vector -> (P, 3). One-hot product, no gather."""
    xg = blk.cam_oh @ x                                       # (P, R, 6)
    t = _matvec(blk.jc, xg)                                   # (P, R, 2)
    return (blk.jp * t[..., None]).sum((1, 2))                # (P, 3)


def _w_apply(blk: ImplicitBlocks, y: torch.Tensor) -> torch.Tensor:
    """W y: (P, 3) point vector -> (C, 6). One-hot product, no scatter."""
    t = _matvec(blk.jp, y[:, None, :])                        # (P, R, 2)
    u = (blk.jc * t[..., None]).sum(-2)                       # (P, R, 6)
    C = blk.cam_oh.shape[-1]
    return blk.cam_oh.reshape(-1, C).T @ u.reshape(-1, 6)     # (C, 6)


def schur_matvec(blk: ImplicitBlocks, x: torch.Tensor) -> torch.Tensor:
    """S x = Hcc x - W Hpp^-1 W^T x without materializing S or W."""
    y = _matvec(blk.hpp_inv, _wt_apply(blk, x))               # (P, 3)
    return _matvec(blk.hcc, x) - _w_apply(blk, y)


@f32_precision
def schur_pcg(
    blk: ImplicitBlocks, cg_iters: int = 25, cg_tol: float = 1e-8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Preconditioned CG on the reduced camera system -> (delta_c (C, 6), the
    number of iterations that changed it, a 0-d int32 tensor).

    Block-Jacobi preconditioner (per-camera 6x6 inverse of the damped Hcc
    diagonal). The JAX package runs a ``lax.while_loop`` until the
    preconditioned residual rz drops to ``cg_tol * rz0`` or ``cg_iters``;
    here every one of the ``cg_iters`` trips runs and its updates of x, r, p
    and rz are kept only while ``rz > thresh``: once stopped, a trip changes
    nothing, so the result is the while loop's, with no host sync. Set
    ``cg_tol=0`` for a fixed trip count.
    """
    b = blk.bc - _w_apply(blk, _matvec(blk.hpp_inv, blk.bp))  # (C, 6)
    minv = torch.linalg.inv_ex(blk.hcc, check_errors=False).inverse   # block Jacobi

    def prec(v):
        return _matvec(minv, v)

    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = (r * z).sum()
    thresh = cg_tol * rz
    n_iters = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(cg_iters):
        active = rz > thresh
        ap = schur_matvec(blk, p)
        pap = (p * ap).sum()
        alpha = torch.where(pap > 1e-20, rz / torch.clamp(pap, min=1e-20), 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z = prec(r_new)
        rz_new = (r_new * z).sum()
        beta = torch.where(rz > 1e-20, rz_new / torch.clamp(rz, min=1e-20), 0.0)
        p = torch.where(active, z + beta * p, p)
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        rz = torch.where(active, rz_new, rz)
        n_iters = n_iters + active.to(torch.int32)
    return x, n_iters


def solve_schur_cg(
    blk: ImplicitBlocks, cg_iters: int = 25, cg_tol: float = 1e-8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Preconditioned CG on the reduced camera system (:func:`schur_pcg`),
    then the landmark back-substitution -> (delta_c, delta_p)."""
    delta_c, _n = schur_pcg(blk, cg_iters, cg_tol)
    delta_p = _matvec(blk.hpp_inv, blk.bp - _wt_apply(blk, delta_c))
    return delta_c, delta_p


def apply_deltas(state: BAState, delta_c: torch.Tensor, delta_p: torch.Tensor) -> BAState:
    return BAState(
        rvecs=state.rvecs + delta_c[:, :3],
        tvecs=state.tvecs + delta_c[:, 3:],
        points=state.points + delta_p,
    )


# C * P above which "auto" prefers the implicit-Schur CG solver: the dense
# cross block W is C*P*18 f32 (4.7 MB at the threshold) and its assembly
# starts to dominate, while CG's grouped layout amortizes. The 50-cam x
# 6400-pt SfM map takes the CG path; small scenes keep the dense solve.
DENSE_CROSS_LIMIT = 65_536


def resolve_solver(n_cams: int, n_points: int, solver: str = "auto") -> str:
    """Pick the Schur solver from STATIC capacities (shapes, not values):
    "auto" -> "cg" when the dense (C, P, 6, 3) cross block would reach
    ``DENSE_CROSS_LIMIT`` camera-point cells, else "dense". Explicit
    "dense"/"cg" pass through."""
    if solver != "auto":
        return solver
    return "cg" if n_cams * n_points >= DENSE_CROSS_LIMIT else "dense"


@f32_precision
def ba_step(
    state: BAState,
    obs: Observations,
    K: torch.Tensor,
    damping=1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    solver: str = "dense",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
    plan: GroupPlan | None = None,
    anchors: Anchors | None = None,
) -> BAState:
    """One damped Gauss-Newton step with Schur-complement elimination.

    ``solver``: "dense" materializes W and solves the (6C, 6C) reduced system
    exactly; "cg" runs the implicit-Schur preconditioned CG (O(M) memory).
    Pass ``plan`` to reuse the grouping across steps. ``anchors`` add
    camera-block information (:class:`Anchors`), in both solvers.
    """
    if solver == "cg":
        blk = assemble_implicit_blocks(
            state, obs, K, damping=damping, huber_delta=huber_delta,
            fix_first_cam=fix_first_cam, plan=plan, anchors=anchors,
        )
        delta_c, delta_p = solve_schur_cg(blk, cg_iters=cg_iters, cg_tol=cg_tol)
    elif solver == "dense":
        blocks = assemble_normal_blocks(
            state, obs, K, huber_delta=huber_delta, fix_first_cam=fix_first_cam,
            anchors=anchors,
        )
        delta_c, delta_p = solve_schur(blocks, damping=damping, fix_first_cam=fix_first_cam)
    else:
        raise ValueError(f"solver must be 'dense' or 'cg', got {solver!r}")
    return apply_deltas(state, delta_c, delta_p)


def _plan_for(state: BAState, obs: Observations, solver: str, max_obs_per_point):
    """(resolved solver, its group plan or None)."""
    solver = resolve_solver(state.rvecs.shape[0], state.points.shape[0], solver)
    plan = None
    if solver == "cg":
        plan = make_group_plan(obs, state.rvecs.shape[0], state.points.shape[0],
                               max_obs_per_point)
    return solver, plan


@f32_precision
def bundle_adjust(
    state: BAState,
    obs: Observations,
    K: torch.Tensor,
    n_iters: int = 10,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    solver: str = "dense",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
    max_obs_per_point: int | None = None,
    anchors: Anchors | None = None,
) -> BAState:
    """Run ``n_iters`` damped Gauss-Newton steps (static trip count).

    ``solver`` may be "auto" (resolved from the static camera/point
    capacities -- :func:`resolve_solver`). For the CG solver the observation
    grouping (make_group_plan) is computed once here and reused by every
    step. ``anchors``: optional fixed-landmark factors (:class:`Anchors`).
    """
    solver, plan = _plan_for(state, obs, solver, max_obs_per_point)
    for _ in range(n_iters):
        state = ba_step(
            state, obs, K, damping=damping, huber_delta=huber_delta,
            fix_first_cam=fix_first_cam, solver=solver, cg_iters=cg_iters,
            cg_tol=cg_tol, plan=plan, anchors=anchors,
        )
    return state


def _huber_sum(r: torch.Tensor, huber_delta: float | None) -> torch.Tensor:
    """Sum of (Huber) losses over (N, 2) residual rows (zero rows -> 0)."""
    n2 = (r * r).sum(-1)
    if huber_delta is None:
        return 0.5 * n2.sum()
    n = torch.sqrt(n2 + 1e-24)
    return torch.where(n <= huber_delta, 0.5 * n2, huber_delta * (n - 0.5 * huber_delta)).sum()


def robust_cost(
    state: BAState,
    obs: Observations,
    K: torch.Tensor,
    huber_delta: float | None = None,
    anchors: Anchors | None = None,
) -> torch.Tensor:
    """The scalar objective Gauss-Newton/LM minimizes: the sum of (Huber)
    losses over valid observations, and over the anchors when given (the
    objective must match what the step linearizes)."""
    c = _huber_sum(residuals(state, obs, K), huber_delta)
    if anchors is not None:
        c = c + _huber_sum(anchor_residuals(state, anchors, K), huber_delta)
    return c


@f32_precision
def bundle_adjust_lm(
    state: BAState,
    obs: Observations,
    K: torch.Tensor,
    max_iters: int = 20,
    lambda_init: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 2.0,
    lambda_max: float = 1e3,
    lambda_min: float = 1e-8,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    solver: str = "auto",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
    max_obs_per_point: int | None = None,
    rel_tol: float = 1e-6,
    anchors: Anchors | None = None,
) -> BAState:
    """Adaptive Levenberg-Marquardt: accept/reject with lambda up/down.

    Every trial step is evaluated on the true objective (:func:`robust_cost`,
    anchors included) and REJECTED if it does not lower it, raising lambda
    (toward gradient descent); accepted steps lower lambda (toward
    Gauss-Newton). The JAX package's ``lax.while_loop`` stops when an
    ACCEPTED step's relative decrease falls below ``rel_tol``, when lambda
    reaches ``lambda_max``, or after ``max_iters``; here all ``max_iters``
    trips run and a trip past the stop changes nothing (``torch.where`` on
    the stop condition), so the result is the while loop's with no host
    sync. ``lambda_min`` only floors the damping on accepted steps.
    """
    solver, plan = _plan_for(state, obs, solver, max_obs_per_point)
    c = robust_cost(state, obs, K, huber_delta, anchors=anchors)
    lam = torch.full((), lambda_init, dtype=torch.float32, device=c.device)
    done = torch.zeros((), dtype=torch.bool, device=c.device)
    for _ in range(max_iters):
        live = (lam < lambda_max) & ~done
        trial = ba_step(
            state, obs, K, damping=lam, huber_delta=huber_delta,
            fix_first_cam=fix_first_cam, solver=solver, cg_iters=cg_iters,
            cg_tol=cg_tol, plan=plan, anchors=anchors,
        )
        c_new = robust_cost(trial, obs, K, huber_delta, anchors=anchors)
        accept = torch.isfinite(c_new) & (c_new < c)
        done_new = accept & (c - c_new <= rel_tol * torch.clamp(c, min=1e-30))
        take = live & accept
        state = BAState(*[torch.where(take, b, a) for a, b in zip(state, trial)])
        lam_new = torch.where(accept, torch.clamp(lam / lambda_down, min=lambda_min),
                              lam * lambda_up)
        lam = torch.where(live, lam_new, lam)
        c = torch.where(take, c_new, c)
        done = torch.where(live, done_new, done)
    return state
