"""Pose-graph optimization (PGO) on SE(3) (port of ``models/pose_graph.py``).

Same shape as ``models/ba``: a fixed-capacity edge list with weights (0 =
invalid), autodiff per-edge Jacobians, per-node sums, damped Gauss-Newton
with a static trip count. Three solvers of a step's normal system:

* "dense": the (N, N, d, d) cross block and one LU of the (dN, dN) system;
* "cg": matrix-free block-Jacobi preconditioned CG (O(E) memory), with the
  JAX package's ``lax.while_loop`` stop as fixed trips masked by
  ``torch.where`` (no host sync);
* "chain": the exact O(N) block-tridiagonal (block-Thomas) solve of the
  odometry chain plus a Woodbury correction for up to ``offchain_cap`` loop
  edges. Its two sweeps are a Python loop over the nodes: about 12 small
  launches a node and a solve.

The solvers' machinery is generic in the block size d, so the Sim(3) graph
(``models/pose_graph_sim3``, d = 7) shares it.

Convention: poses are world->cam (R_i, t_i) as axis-angle + translation;
edge (i, j) measures the relative transform cam_i -> cam_j:
R_rel = R_j R_i^T, t_rel = t_j - R_rel t_i.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.models.ba import _one_hot
from sift_parallel_optimization_tpu_torch.models.geometry import rodrigues, rotation_log
from sift_parallel_optimization_tpu_torch.utils.convert import tuple_from_numpy, tuple_to_numpy
from sift_parallel_optimization_tpu_torch.utils.device import f32_precision


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity relative-pose constraint list."""

    i: torch.Tensor         # (E,) int32 source node
    j: torch.Tensor         # (E,) int32 target node
    rel_rvec: torch.Tensor  # (E, 3) measured relative rotation (axis-angle)
    rel_tvec: torch.Tensor  # (E, 3) measured relative translation
    weight: torch.Tensor    # (E,) f32 information weight (0 = invalid)


class Poses(NamedTuple):
    rvecs: torch.Tensor  # (N, 3)
    tvecs: torch.Tensor  # (N, 3)


def pose_graph_edges_from_numpy(arrays, device=None) -> PoseGraphEdges:
    """PoseGraphEdges from numpy arrays (``utils/convert.tuple_from_numpy``:
    e.g. the JAX package's edges). ``device`` None means the card, and raises
    without one."""
    return tuple_from_numpy(PoseGraphEdges, arrays, {"i": torch.int32, "j": torch.int32},
                            device)


def poses_from_numpy(arrays, device=None) -> Poses:
    """Poses from numpy arrays (same rules as :func:`pose_graph_edges_from_numpy`)."""
    return tuple_from_numpy(Poses, arrays, {}, device)


pose_graph_edges_to_numpy = poses_to_numpy = tuple_to_numpy


def relative_pose(ri, ti, rj, tj):
    """(rvec_rel, tvec_rel) of cam_i -> cam_j; leading axes broadcast."""
    Ri, Rj = rodrigues(ri), rodrigues(rj)
    R_rel = Rj @ Ri.transpose(-1, -2)
    t_rel = tj - (R_rel @ ti[..., None])[..., 0]
    return rotation_log(R_rel), t_rel


def _edge_residual(ri, ti, rj, tj, rel_r, rel_t):
    """(..., 6) residual: [log(R_meas^T R_rel); t_rel - t_meas]."""
    Ri, Rj = rodrigues(ri), rodrigues(rj)
    R_rel = Rj @ Ri.transpose(-1, -2)
    t_rel = tj - (R_rel @ ti[..., None])[..., 0]
    e_rot = rotation_log(rodrigues(rel_r).transpose(-1, -2) @ R_rel)
    return torch.cat([e_rot, t_rel - rel_t], dim=-1)


@f32_precision
def pgo_residuals(poses: Poses, edges: PoseGraphEdges) -> torch.Tensor:
    """(E, 6) weighted residuals (zero for invalid edges)."""
    i, j = edges.i.long(), edges.j.long()
    r = _edge_residual(poses.rvecs[i], poses.tvecs[i], poses.rvecs[j], poses.tvecs[j],
                       edges.rel_rvec, edges.rel_tvec)
    return r * torch.sqrt(torch.clamp(edges.weight, min=0.0))[:, None]


def pgo_rms(poses: Poses, edges: PoseGraphEdges) -> torch.Tensor:
    r = pgo_residuals(poses, edges)
    n = torch.clamp((edges.weight > 0).sum(), min=1)
    return torch.sqrt((r * r).sum() / n)


def _weighted_residual(theta, rel_r, rel_t, w):
    """One edge's weighted residual of its stacked (12,) node parameters,
    twice (the second as ``jacfwd``'s auxiliary output)."""
    r = _edge_residual(theta[:3], theta[3:6], theta[6:9], theta[9:], rel_r, rel_t) * \
        torch.sqrt(torch.clamp(w, min=0.0))
    return r, r


def _edge_jacobians(poses: Poses, edges: PoseGraphEdges):
    """Weighted, gauge-masked per-edge Jacobians and residuals.

    Returns ji (E, 6, 6) = d r_e / d pose_i, jj (E, 6, 6), r (E, 6), all
    scaled by sqrt(weight) and with node-0 blocks zeroed (gauge fixing). The
    Jacobians are forward-mode autodiff of the residual, as ``jax.jacfwd``
    in the JAX package: through ``rotation_log`` the tangent of its unchosen
    branch never reaches the output (``torch.where`` selects tangents), so
    a padded edge (i = j = 0, rel = 0, at exactly the identity) has finite
    -- zero -- Jacobians.
    """
    from torch.func import jacfwd, vmap

    i, j = edges.i.long(), edges.j.long()
    theta = torch.cat([poses.rvecs[i], poses.tvecs[i], poses.rvecs[j], poses.tvecs[j]], dim=-1)
    jac, r = vmap(jacfwd(_weighted_residual, has_aux=True))(
        theta, edges.rel_rvec, edges.rel_tvec, edges.weight)
    keep_i = (edges.i != 0)[:, None, None].to(jac.dtype)
    keep_j = (edges.j != 0)[:, None, None].to(jac.dtype)
    return jac[..., :6] * keep_i, jac[..., 6:] * keep_j, r


def _node_sum(values: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``segment_sum``: (E, ...) rows summed into (n, ...) by ``idx``.

    An accumulating ``index_put_`` and not ``index_add_``: on the card it
    sorts the indices and sums each node's rows in edge order, where
    ``index_add_`` adds with atomics in whatever order they land, so two
    runs of the same pose graph gave results ~1.6e-4 apart."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_put_((idx.long(),), values, accumulate=True)


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, i, k) x (E, i, l) -> (E, k, l): per-edge J^T J."""
    return a.transpose(-1, -2) @ b


def _jtr(jac: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(E, i, k) x (E, i) -> (E, k): per-edge J^T r."""
    return (jac * r[..., None]).sum(-2)


def _hdiag(ji, jj, i, j, n: int) -> torch.Tensor:
    """(n, d, d) diagonal blocks of J^T J: each edge's Gram blocks summed
    into its two nodes."""
    return _node_sum(_gram(ji, ji), i, n) + _node_sum(_gram(jj, jj), j, n)


def _rhs(ji, jj, r, i, j, n: int) -> torch.Tensor:
    """(n, d) right-hand side -J^T r."""
    return -(_node_sum(_jtr(ji, r), i, n) + _node_sum(_jtr(jj, r), j, n))


def _gauge(b: torch.Tensor) -> torch.Tensor:
    """``b`` with node 0's row (the gauge) zeroed."""
    return torch.cat([torch.zeros_like(b[:1]), b[1:]])


def _normal_blocks(ji, jj, r, i, j, n: int):
    """Normal-equation blocks of per-edge Jacobians (any block size d):
    hdiag (n, d, d), cross (n, n, d, d), b (n, d)."""
    d = ji.shape[-1]
    cross = _node_sum(_gram(ji, jj).reshape(-1, d * d), i.long() * n + j.long(), n * n)
    return _hdiag(ji, jj, i, j, n), cross.reshape(n, n, d, d), _rhs(ji, jj, r, i, j, n)


@f32_precision
def assemble_pgo_blocks(poses: Poses, edges: PoseGraphEdges):
    """Normal-equation blocks (hdiag (N, 6, 6), cross (N, N, 6, 6), b (N, 6));
    summing over edge shards commutes, so a sum over shards of the returned
    tuple is the global system."""
    ji, jj, r = _edge_jacobians(poses, edges)
    return _normal_blocks(ji, jj, r, edges.i, edges.j, poses.rvecs.shape[0])


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x = b (b a matrix of right-hand sides) that never raises: a singular
    system gives inf/nan, as ``jnp.linalg.solve`` does."""
    return torch.linalg.solve_ex(a, b, check_errors=False).result


@f32_precision
def solve_pgo(hdiag, cross, b, damping: float = 1e-3) -> torch.Tensor:
    """Dense solve of the (dN, dN) system -> (N, d) update (d = 6 for SE(3),
    7 for Sim(3))."""
    N, d = b.shape
    h = cross + cross.permute(1, 0, 3, 2)
    nodes = torch.arange(N, device=h.device)
    h[nodes, nodes] += hdiag
    # Marquardt-scaled damping (see models/ba for the f32 rationale).
    dg = torch.diagonal(h[nodes, nodes], dim1=-2, dim2=-1)
    h[nodes, nodes] += (damping * dg + 1e-6)[..., None] * torch.eye(d, device=h.device)
    hd = h.permute(0, 2, 1, 3).reshape(d * N, d * N)
    m0 = torch.ones(d * N, dtype=hd.dtype, device=hd.device)
    m0[:d] = 0.0
    hd = hd * m0[:, None] * m0[None, :] + torch.diag(1.0 - m0)
    return _solve(hd, _gauge(b).reshape(-1, 1)).reshape(N, d)


# ---------------------------------------------------------------------------
# Implicit CG path (the scalable solver: no dense (N, N, d, d) cross block)
# ---------------------------------------------------------------------------


class ImplicitPgo(NamedTuple):
    """Per-GN-step linearization for the matrix-free solve: O(E) memory.

    H = J^T J is only ever APPLIED through per-edge products; the node
    assignment is carried as one-hot (E, N) tensors, so the matvec's gather
    and scatter are dense products, as in the JAX package. Any block size d
    (6 here, 7 for Sim(3)).
    """

    ji: torch.Tensor        # (E, d, d) weighted gauge-masked d r / d pose_i
    jj: torch.Tensor        # (E, d, d)
    oh_i: torch.Tensor      # (E, N) one-hot source node
    oh_j: torch.Tensor      # (E, N) one-hot target node
    damp_vec: torch.Tensor  # (N, d) Marquardt damping diagonal addition
    minv: torch.Tensor      # (N, d, d) block-Jacobi preconditioner
    b: torch.Tensor         # (N, d) right-hand side (node 0 zeroed)


def _implicit_blocks(ji, jj, r, i, j, n: int, damping: float) -> ImplicitPgo:
    """:class:`ImplicitPgo` of per-edge Jacobians (any block size d)."""
    d = ji.shape[-1]
    hdiag = _hdiag(ji, jj, i, j, n)
    damp_vec = damping * torch.diagonal(hdiag, dim1=-2, dim2=-1) + 1e-6
    eye = torch.eye(d, dtype=ji.dtype, device=ji.device)
    prec = hdiag + damp_vec[..., None] * eye
    prec = torch.cat([eye[None], prec[1:]])          # gauge: node-0 block is identity
    return ImplicitPgo(
        ji=ji, jj=jj, oh_i=_one_hot(i, n), oh_j=_one_hot(j, n), damp_vec=damp_vec,
        minv=torch.linalg.inv_ex(prec, check_errors=False).inverse,
        b=_gauge(_rhs(ji, jj, r, i, j, n)),
    )


@f32_precision
def assemble_pgo_implicit(poses: Poses, edges: PoseGraphEdges,
                          damping: float = 1e-3) -> ImplicitPgo:
    """Linearize for the matrix-free CG solve (no N x N block anywhere)."""
    ji, jj, r = _edge_jacobians(poses, edges)
    return _implicit_blocks(ji, jj, r, edges.i, edges.j, poses.rvecs.shape[0], damping)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j) -> (..., i), as a broadcast product and sum."""
    return (m * v[..., None, :]).sum(-1)


def pgo_matvec(blk: ImplicitPgo, x: torch.Tensor) -> torch.Tensor:
    """(damped H) x through per-edge products: (N, d) -> (N, d)."""
    t = _matvec(blk.ji, blk.oh_i @ x) + _matvec(blk.jj, blk.oh_j @ x)   # (E, d) = J x
    out = blk.oh_i.T @ _jtr(blk.ji, t) + blk.oh_j.T @ _jtr(blk.jj, t)
    out = out + blk.damp_vec * x
    # Node-0 gauge block is the identity (its Jacobians are masked, so the
    # edge products and x_0 columns are already zero there).
    return torch.cat([x[:1], out[1:]])


@f32_precision
def pgo_pcg(blk: ImplicitPgo, cg_iters: int = 100,
            cg_tol: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-Jacobi preconditioned CG -> ((N, d) update, the number of trips
    that changed it as a 0-d int32 tensor).

    The JAX package runs a ``lax.while_loop`` until the preconditioned
    residual rz drops to ``cg_tol * rz0`` or ``cg_iters`` trips; here every
    trip runs and its updates are kept only while ``rz > thresh``, so the
    result is the while loop's, with no host sync (``models/ba.schur_pcg``).
    """

    def prec(v):
        return _matvec(blk.minv, v)

    b = blk.b
    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = (r * z).sum()
    thresh = cg_tol * rz
    trips = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(cg_iters):
        active = rz > thresh
        ap = pgo_matvec(blk, p)
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
        trips = trips + active.to(torch.int32)
    return x, trips


def solve_pgo_cg(blk: ImplicitPgo, cg_iters: int = 100, cg_tol: float = 1e-8) -> torch.Tensor:
    """Block-Jacobi preconditioned CG -> (N, d) update (:func:`pgo_pcg`)."""
    return pgo_pcg(blk, cg_iters, cg_tol)[0]


# ---------------------------------------------------------------------------
# Chain solver: exact O(N) block-tridiagonal + Woodbury loop correction
# (block-size generic: the Sim(3) module reuses it with 7-DOF blocks). On
# odometry-shaped graphs CG stalls on the chain's N^2-conditioned global
# modes, while the chain part of H is exactly solvable in O(N) by
# block-Thomas elimination and the L loop edges are a rank-dL Woodbury
# correction (``models/pose_graph_sim3`` has the full argument).
# ---------------------------------------------------------------------------


def block_tridiag_solve(diag: torch.Tensor, off: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the SPD block-tridiagonal system T X = RHS.

    diag (N, d, d), off (N-1, d, d) = block (i, i+1), rhs (N, d, k) ->
    (N, d, k). The JAX package's two ``lax.scan`` sweeps of (d, d+k) solves
    are two loops over the nodes: O(N) work and memory, ~12 launches a node.
    """
    n, d = diag.shape[0], diag.shape[-1]
    diag_l, off_l, rhs_l = diag.unbind(0), off.unbind(0), rhs.unbind(0)
    g, y = [], []
    for i in range(n):
        denom, b_i = diag_l[i], rhs_l[i]
        if i > 0:
            o_prev = off_l[i - 1].T                    # block (i, i-1)
            denom = denom - o_prev @ g[-1]
            b_i = b_i - o_prev @ y[-1]
        o_next = off_l[i] if i < n - 1 else torch.zeros_like(denom)
        sol = _solve(denom, torch.cat([o_next, b_i], dim=1))
        g.append(sol[:, :d])
        y.append(sol[:, d:])
    x = [y[-1]]
    for i in range(n - 2, -1, -1):
        x.append(y[i] - g[i] @ x[-1])
    return torch.stack(x[::-1])


def chain_woodbury_delta(diag, off, u_ji, u_jj, u_i, u_j, b) -> torch.Tensor:
    """Exact (N, d) update of (T + U^T U) x = b via Woodbury.

    T is the damped chain tridiagonal (diag/off); U stacks the L off-chain
    (loop) edges' weighted Jacobian rows: row block l applies u_ji[l] at
    node u_i[l] and u_jj[l] at node u_j[l]. One factorization solves 1 + dL
    right-hand sides in the same two block-Thomas sweeps; the (dL, dL)
    capacitance solve is dense but tiny. Exact: the dense solver's fixed
    point.
    """
    N, d = b.shape
    L = u_i.shape[0]
    # U^T as a dense (N, d, dL) multi-RHS block: loop slot l writes u_ji[l]^T
    # at node u_i[l]'s rows of column block l (distinct column blocks, no
    # collisions; one-hot products, as in the JAX package).
    ut = (torch.einsum("ln,lba->nalb", _one_hot(u_i, N, b.dtype), u_ji)
          + torch.einsum("ln,lba->nalb", _one_hot(u_j, N, b.dtype), u_jj))
    rhs = torch.cat([b[..., None], ut.reshape(N, d, L * d)], dim=-1)
    x = block_tridiag_solve(diag, off, rhs)                     # (N, d, 1 + dL)
    tb, tu = x[..., 0], x[..., 1:]

    def apply_u(m):
        # U @ m for m (N, d, k): gather rows at the loop nodes.
        return (u_ji @ m[u_i.long()] + u_jj @ m[u_j.long()]).reshape(L * d, -1)

    s = torch.eye(L * d, dtype=b.dtype, device=b.device) + apply_u(tu)   # capacitance
    w = _solve(s, apply_u(tb[..., None]))                                # (dL, 1)
    return tb - (tu * w[:, 0]).sum(-1)


def chain_edge_split(ji, jj, r, edges, N: int, damping: float, offchain_cap: int):
    """Shared chain/loop split + damped tridiagonal assembly.

    Returns (diag, off, u_ji, u_jj, u_i, u_j, b) for
    :func:`chain_woodbury_delta`. Chain edges are detected structurally
    (j == i + 1, weight > 0); ALL other valid edges are compacted into
    ``offchain_cap`` low-rank slots (the caller must guarantee the true
    off-chain count fits: host-known where a trajectory is corrected). Gradient
    and Marquardt damping come from the FULL system so the step matches the
    dense solver's exactly.
    """
    d = ji.shape[-1]
    valid = edges.weight > 0
    chain = valid & (edges.j == edges.i + 1)
    cf = chain.to(ji.dtype)[:, None, None]
    diag = _hdiag(cf * ji, cf * jj, edges.i, edges.j, N)
    off = _node_sum(cf * _gram(ji, jj), edges.i, N)[: N - 1]
    b = _gauge(_rhs(ji, jj, r, edges.i, edges.j, N))
    dg = torch.diagonal(_hdiag(ji, jj, edges.i, edges.j, N), dim1=-2, dim2=-1)
    eye = torch.eye(d, dtype=ji.dtype, device=ji.device)
    # Off-chain edges' diagonal contributions ride the Woodbury term.
    diag = diag + (damping * dg + 1e-6)[..., None] * eye
    diag = torch.cat([eye[None], diag[1:]])             # node-0 gauge block
    loop = valid & ~chain
    sel = torch.argsort((~loop).to(torch.uint8), stable=True)[:offchain_cap]
    lf = loop[sel].to(ji.dtype)[:, None, None]
    zero = torch.zeros_like(edges.i[sel])
    return (diag, off, ji[sel] * lf, jj[sel] * lf,
            torch.where(loop[sel], edges.i[sel], zero), torch.where(loop[sel], edges.j[sel], zero),
            b)


def chain_damping(n_nodes: int, damping: float, limit: int | None = None) -> float:
    """Length-aware Marquardt damping for long-chain graphs.

    lambda * diag(H) suppresses update components along eigendirections
    below lambda * diag; a chain's lowest structural mode (the global ramp
    the loop edges exist to fix) has eigenvalue ~ diag / N^2, so a fixed
    lambda freezes it once N >~ 100. Scaling by (limit / N)^2 keeps the
    damped spectrum's floor below the slowest physical mode at any length
    while leaving small-N behaviour untouched.
    """
    if limit is None:
        limit = PGO_DENSE_LIMIT
    return damping * min(1.0, (limit / max(n_nodes, 1)) ** 2)


@f32_precision
def assemble_pgo_chain(poses: Poses, edges: PoseGraphEdges, damping: float = 1e-3,
                       offchain_cap: int = 32):
    """Linearize + split for the SE(3) chain+Woodbury solve."""
    ji, jj, r = _edge_jacobians(poses, edges)
    return chain_edge_split(ji, jj, r, edges, poses.rvecs.shape[0], damping, offchain_cap)


@f32_precision
def solve_pgo_chain(blk) -> torch.Tensor:
    """Exact (N, 6) update via block-Thomas + Woodbury
    (:func:`chain_woodbury_delta`)."""
    return chain_woodbury_delta(*blk)


# N above which "auto" prefers a scalable solver: the dense cross block is
# N*N*36 f32 (9.4 MB at the threshold, growing quadratically) and the
# (6N, 6N) LU solve grows cubically, while the chain solve stays O(N) and the
# CG matvec O(E).
PGO_DENSE_LIMIT = 256


def resolve_pgo_solver(n_nodes: int, solver: str = "auto", offchain_cap: int | None = None) -> str:
    """"auto" keeps the dense solve at small N; above the limit it takes the
    exact chain+Woodbury solve when the caller vouches for an off-chain edge
    cap, else matrix-free CG (structure-agnostic, but slow to diffuse loop
    corrections along long chains)."""
    if solver not in ("auto", "dense", "cg", "chain"):
        raise ValueError(f"solver must be 'auto', 'dense', 'cg' or 'chain', got {solver!r}")
    if solver != "auto":
        return solver
    if n_nodes <= PGO_DENSE_LIMIT:
        return "dense"
    return "chain" if offchain_cap is not None else "cg"


@f32_precision
def pgo_step(poses: Poses, edges: PoseGraphEdges, damping: float = 1e-3,
             solver: str = "dense", cg_iters: int = 100, cg_tol: float = 1e-8,
             offchain_cap: int = 32) -> Poses:
    solver = resolve_pgo_solver(poses.rvecs.shape[0], solver, offchain_cap)
    if solver == "cg":
        delta = solve_pgo_cg(assemble_pgo_implicit(poses, edges, damping), cg_iters, cg_tol)
    elif solver == "chain":
        delta = solve_pgo_chain(assemble_pgo_chain(poses, edges, damping, offchain_cap))
    else:
        delta = solve_pgo(*assemble_pgo_blocks(poses, edges), damping)
    return Poses(rvecs=poses.rvecs + delta[:, :3], tvecs=poses.tvecs + delta[:, 3:])


@f32_precision
def optimize_pose_graph(
    poses: Poses,
    edges: PoseGraphEdges,
    n_iters: int = 20,
    damping: float = 1e-3,
    solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-8,
    offchain_cap: int | None = None,
) -> Poses:
    """Damped Gauss-Newton PGO with a static trip count.

    ``solver``: "dense" materializes the (N, N, 6, 6) cross block and LU-
    solves the (6N, 6N) system (best at small N); "chain" is the exact O(N)
    block-tridiagonal + Woodbury solve for odometry-shaped graphs (chain +
    up to ``offchain_cap`` loop edges); "cg" is the matrix-free
    block-Jacobi-preconditioned CG (O(E) memory, structure-agnostic); "auto"
    picks by node count and cap availability (:func:`resolve_pgo_solver`).
    """
    solver = resolve_pgo_solver(poses.rvecs.shape[0], solver, offchain_cap)
    for _ in range(n_iters):
        poses = pgo_step(poses, edges, damping, solver=solver, cg_iters=cg_iters,
                         cg_tol=cg_tol, offchain_cap=32 if offchain_cap is None else offchain_cap)
    return poses
