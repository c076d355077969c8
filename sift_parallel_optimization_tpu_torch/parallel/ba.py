"""Distributed bundle adjustment over a mesh axis (port of ``parallel/ba.py``).

Where the reference streamed rows to one collector rank that did all the
reduction work (GaussDePyramid-MPI.h:265-335, mpitest.cpp:35-113), BA here
distributes its dominant cost, the per-observation linearization and block
assembly, and reduces with collectives:

  * the observation list is split over the ``data`` axis (every rank passes
    the same padded list to :func:`distributed_bundle_adjust` and keeps its
    contiguous block);
  * dense step: every rank assembles the normal blocks of its block and ONE
    all-reduce of all of them gives the global normal equations on every
    rank; the reduced camera solve and the landmark back-substitution run
    replicated, so every rank holds the whole updated state;
  * CG step (no dense camera-point block anywhere): one all-reduce of the
    camera blocks, one reduce-scatter that leaves each rank the (P/n, 3, 3)
    landmark blocks it inverts and applies, and per matvec a reduce-scatter
    and an all-gather of the (P, 3) landmark vector and an all-reduce of the
    (C, 6) camera vector.

The JAX CG runs a ``lax.while_loop`` on the residual; here every one of
``cg_iters`` trips runs, its updates gated by ``torch.where`` on the same
test (``models/ba.masked_pcg``), so no trip reads the device from the host
and every rank issues the same collectives. Sums over observations are
accumulating ``index_put_`` (``models/pose_graph._node_sum``: sorted, a
fixed order on the card), in full fp32 (``utils/device.fp32_matmul``).
"""

from __future__ import annotations

import torch

from sift_parallel_optimization_tpu_torch.models.ba import (
    BAState,
    NormalBlocks,
    Observations,
    _damp_blocks,
    _gram,
    _inv3x3,
    _jtr,
    _linearize,
    _matvec,
    apply_deltas,
    assemble_normal_blocks,
    masked_pcg,
    solve_schur,
)
from sift_parallel_optimization_tpu_torch.models.pose_graph import _node_sum as _segment_sum
from sift_parallel_optimization_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce,
    all_reduce_all,
    axis_index,
    axis_size,
    check_device,
    reduce_scatter,
)
from sift_parallel_optimization_tpu_torch.utils.device import f32_precision


def pad_observations(obs: Observations, multiple: int) -> Observations:
    """Pad the observation list so it divides the mesh axis (invalid slots
    on camera 0 and point 0, which contribute nothing)."""
    m = obs.cam_idx.shape[0]
    pad = -(-m // multiple) * multiple - m
    if pad == 0:
        return obs
    return Observations(*[torch.cat([f, f.new_zeros((pad, *f.shape[1:]))]) for f in obs])


def local_observations(obs: Observations, mesh, axis: str = "data") -> Observations:
    """This rank's contiguous block of a list whose length divides the axis."""
    n = axis_size(mesh, axis)
    m = obs.cam_idx.shape[0]
    if m % n:
        raise ValueError(f"{m} observations do not split {n} ways (pad_observations)")
    i = axis_index(mesh, axis)
    return Observations(*[f[i * (m // n):(i + 1) * (m // n)] for f in obs])


def distributed_ba_step(mesh, K: torch.Tensor, damping: float = 1e-3,
                        huber_delta: float | None = None, fix_first_cam: bool = True,
                        axis: str = "data"):
    """fn(state, this rank's observations) -> state: one sharded
    Gauss-Newton step with the exact reduced solve. State is replicated."""

    @f32_precision
    def step(state: BAState, obs: Observations) -> BAState:
        check_device(obs.uv, mesh)
        blocks = assemble_normal_blocks(state, obs, K, huber_delta=huber_delta,
                                        fix_first_cam=fix_first_cam)
        blocks = NormalBlocks(*all_reduce_all(blocks, mesh, axis))
        dc, dp = solve_schur(blocks, damping=damping, fix_first_cam=fix_first_cam)
        return apply_deltas(state, dc, dp)

    return step


def distributed_ba_step_cg(mesh, K: torch.Tensor, damping: float = 1e-3,
                           huber_delta: float | None = None, fix_first_cam: bool = True,
                           axis: str = "data", cg_iters: int = 25, cg_tol: float = 1e-8):
    """fn(state, this rank's observations) -> state: one implicit-Schur CG
    Gauss-Newton step, sharded over observations (module docstring). The
    CG recurrence runs replicated: the collectives keep every rank in
    lockstep, and every rank runs all ``cg_iters`` trips."""
    n_dev = axis_size(mesh, axis)

    @f32_precision
    def step(st: BAState, ob: Observations) -> BAState:
        check_device(ob.uv, mesh)
        C, P = st.rvecs.shape[0], st.points.shape[0]
        # The point axis padded so the landmark blocks split evenly; pad
        # blocks are damped identity and their updates are sliced off.
        p_pad = -(-P // n_dev) * n_dev
        jc, jp, r = _linearize(st, ob, K, huber_delta, fix_first_cam)
        cam, pt = ob.cam_idx, ob.pt_idx
        hcc, bc = all_reduce_all([_segment_sum(_gram(jc, jc), cam, C),
                                  -_segment_sum(_jtr(jc, r), cam, C)], mesh, axis)
        # One reduce-scatter of the (p_pad, 9 + 3) landmark blocks.
        p_part = torch.cat([_segment_sum(_gram(jp, jp).reshape(-1, 9), pt, p_pad),
                            -_segment_sum(_jtr(jp, r), pt, p_pad)], dim=1)
        p_shard = reduce_scatter(p_part, mesh, axis)
        hpp_shard, bp_shard = p_shard[:, :9].reshape(-1, 3, 3), p_shard[:, 9:]
        hcc = _damp_blocks(hcc, damping)
        if fix_first_cam:
            hcc = torch.cat([torch.eye(6, dtype=hcc.dtype, device=hcc.device)[None], hcc[1:]])
        hpp_inv_shard = _inv3x3(_damp_blocks(hpp_shard, damping))

        def wt_shard(x):
            """W^T x -> the owner's (p_pad / n, 3) landmark shard."""
            t = _matvec(jc, x[cam.long()])
            u = (jp * t[..., None]).sum(-2)
            return reduce_scatter(_segment_sum(u, pt, p_pad), mesh, axis)

        def w_apply(y_full):
            """W y -> the replicated (C, 6) camera vector."""
            t = _matvec(jp, y_full[pt.long()])
            u = (jc * t[..., None]).sum(-2)
            return all_reduce(_segment_sum(u, cam, C), mesh, axis)

        def hpp_solve_gather(v_shard):
            """The owned Hpp^-1 applied, all-gathered to (p_pad, 3)."""
            return all_gather(_matvec(hpp_inv_shard, v_shard), mesh, axis)

        b = bc - w_apply(hpp_solve_gather(bp_shard))

        def matvec(x):
            return _matvec(hcc, x) - w_apply(hpp_solve_gather(wt_shard(x)))

        x, _trips = masked_pcg(b, matvec, hcc, cg_iters, cg_tol)
        dp_shard = _matvec(hpp_inv_shard, bp_shard - wt_shard(x))
        delta_p = all_gather(dp_shard, mesh, axis)[:P]
        return apply_deltas(st, x, delta_p)

    return step


@f32_precision
def distributed_bundle_adjust(
    state: BAState,
    obs: Observations,
    K: torch.Tensor,
    mesh,
    n_iters: int = 10,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    axis: str = "data",
    solver: str = "dense",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
) -> BAState:
    """``n_iters`` sharded damped Gauss-Newton steps. Every rank passes the
    same state and observations and gets the same state back. ``solver``:
    "dense" (the exact reduced solve) or "cg" (implicit Schur)."""
    obs = local_observations(pad_observations(obs, axis_size(mesh, axis)), mesh, axis)
    if solver == "cg":
        step = distributed_ba_step_cg(mesh, K, damping=damping, huber_delta=huber_delta,
                                      fix_first_cam=fix_first_cam, axis=axis,
                                      cg_iters=cg_iters, cg_tol=cg_tol)
    elif solver == "dense":
        step = distributed_ba_step(mesh, K, damping=damping, huber_delta=huber_delta,
                                   fix_first_cam=fix_first_cam, axis=axis)
    else:
        raise ValueError(f"solver must be 'dense' or 'cg', got {solver!r}")
    for _ in range(n_iters):
        state = step(state, obs)
    return state
