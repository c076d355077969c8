"""Pairwise keyframe matching for SfM pair selection (port of
``parallel/matching.py``).

Global SfM pair selection needs the (F, F) table of pairwise match counts
over F keyframes. ``pairwise_match_counts`` computes it on one device, one
row of the table (frame a against all F frames) per batched product.

``ring_pairwise_match_counts`` shards the same computation over a mesh axis
(the JAX package's ring schedule, the analogue of the reference's
scale-owner rank split, mpitest.cpp:42-93, applied to keyframes): each of n
ranks owns a stationary block of F/n keyframes, the ROWS of its stripe of
the table; a travelling copy of each block walks the ring, one neighbour
hop a step (posted before the step's tile and waited for after it), and at
step r rank d scores its block against the block that started at rank
(d - r) mod n. Each entry is the single-device matcher's, so the table is
the single-device table, gathered.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from sift_parallel_optimization_tpu_torch.core.pyramid_ref import check_fp32_matmul
from sift_parallel_optimization_tpu_torch.parallel.mesh import (
    all_gather,
    axis_group,
    axis_index,
    axis_peer,
    axis_size,
    check_device,
)


def _row_counts(desc_a, valid_a, desc_b, valid_b, ratio: float) -> torch.Tensor:
    """(F,) match counts of one frame's (K, 128) descriptors against F
    frames' (F, K, 128): ``models/matching.match_descriptors(...).count()``
    with a leading frame axis (ratio test, mutual nearest neighbour, first
    index among ties)."""
    neg_inf = torch.full((), -torch.inf, dtype=torch.float32, device=desc_a.device)
    sim = torch.matmul(desc_a.to(torch.float32), desc_b.to(torch.float32).transpose(1, 2))
    sim = torch.where(valid_b[:, None, :], sim, neg_inf)                 # (F, K1, K2)
    s1 = sim.amax(dim=2)
    best = torch.argmax(sim, dim=2)                                      # (F, K1)
    cols = torch.arange(sim.shape[2], device=sim.device)
    s2 = torch.where(cols == best[..., None], neg_inf, sim).amax(dim=2)
    ok = valid_a & ((2.0 - 2.0 * s1) < (ratio * ratio) * (2.0 - 2.0 * s2)) & torch.isfinite(s1)
    back = torch.argmax(torch.where(valid_a[None, :, None], sim, neg_inf), dim=1)  # (F, K2)
    rows = torch.arange(sim.shape[1], device=sim.device)
    ok = ok & (torch.gather(back, 1, best) == rows)
    return ok.to(torch.int32).sum(dim=1)


def _pair_tile_counts(desc_a, valid_a, desc_b, valid_b, ratio: float) -> torch.Tensor:
    """(fa, fb) int32 match counts of a stationary block against a
    travelling one, a row of the tile per batched product."""
    return torch.stack([_row_counts(desc_a[a], valid_a[a], desc_b, valid_b, ratio)
                        for a in range(desc_a.shape[0])])


def pairwise_match_counts(
    descriptors: torch.Tensor,  # (F, K, 128)
    valid: torch.Tensor,        # (F, K)
    ratio: float = 0.8,
) -> torch.Tensor:
    """(F, F) int32 pairwise match-count table on ONE device: entry (i, j)
    counts ratio + mutual matches of frame i's descriptors against frame
    j's, as looping ``match_descriptors(...).count()`` over all ordered
    pairs does. The diagonal is the self-match count."""
    check_fp32_matmul(descriptors)
    return _pair_tile_counts(descriptors, valid, descriptors, valid, ratio)


def _ring_stripe(desc_loc, valid_loc, mesh, axis: str, ratio: float) -> torch.Tensor:
    """(f_loc, n * f_loc) stripe of the table: this rank's block against
    every block, as the blocks come round the ring."""
    n, d = axis_size(mesh, axis), axis_index(mesh, axis)
    f_loc = desc_loc.shape[0]
    out = torch.zeros((f_loc, n * f_loc), dtype=torch.int32, device=desc_loc.device)
    group = axis_group(mesh, axis)
    nxt, prv = axis_peer(mesh, axis, (d + 1) % n), axis_peer(mesh, axis, (d - 1) % n)
    trav = (desc_loc, valid_loc.to(torch.uint8))
    for r in range(n):
        works, incoming = [], None
        if r < n - 1:           # pass the block on while this step's tile runs
            incoming = tuple(torch.empty_like(t) for t in trav)
            ops = [dist.P2POp(dist.isend, t, nxt, group, tag=i) for i, t in enumerate(trav)]
            ops += [dist.P2POp(dist.irecv, t, prv, group, tag=i) for i, t in enumerate(incoming)]
            works = dist.batch_isend_irecv(ops)
        src = (d - r) % n
        out[:, src * f_loc:(src + 1) * f_loc] = _pair_tile_counts(
            desc_loc, valid_loc, trav[0], trav[1].to(torch.bool), ratio)
        for w in works:
            w.wait()
        if incoming is not None:
            trav = incoming
    return out


def ring_pairwise_match_counts(
    mesh,
    descriptors: torch.Tensor,  # (F, K, 128)
    valid: torch.Tensor,        # (F, K)
    axis: str = "data",
    ratio: float = 0.8,
) -> torch.Tensor:
    """(F, F) int32 pairwise match-count table, keyframes sharded over
    ``axis`` of ``mesh``; every rank passes the same (F, K, 128) descriptors
    and gets the whole table (the stripes all-gathered).

    F is padded up to a multiple of the axis size with invalid frames (zero
    counts); entry (i, j) equals :func:`pairwise_match_counts`'s.
    """
    check_fp32_matmul(descriptors)
    check_device(descriptors, mesh)
    F = descriptors.shape[0]
    n = axis_size(mesh, axis)
    f_pad = -(-F // n) * n
    if f_pad != F:
        descriptors = torch.cat([descriptors, descriptors.new_zeros(
            (f_pad - F, *descriptors.shape[1:]))])
        valid = torch.cat([valid, valid.new_zeros((f_pad - F, valid.shape[1]))])
    f_loc = f_pad // n
    d = axis_index(mesh, axis)
    stripe = _ring_stripe(descriptors[d * f_loc:(d + 1) * f_loc].contiguous(),
                          valid[d * f_loc:(d + 1) * f_loc].contiguous(), mesh, axis, ratio)
    return all_gather(stripe, mesh, axis)[:F, :F]


def covisibility_order(table) -> tuple[list[int], dict[int, int]]:
    """Greedy covisibility-first registration plan from a match table.

    Prim-style maximum-spanning-tree over the symmetrized pair counts: start
    at the strongest pair, then repeatedly admit the unregistered frame with
    the highest count against ANY registered frame, recording that frame as
    its triangulation PARTNER. Host-side O(F^2) numpy on the fetched table.
    Returns (order, partner): ``order[0]``/``order[1]`` are the bootstrap
    pair; ``partner[f]`` is the registration partner of every later frame.
    """
    t = np.asarray(table)
    sym = t + t.T
    np.fill_diagonal(sym, -1)
    F = sym.shape[0]
    a, b = np.unravel_index(np.argmax(sym), sym.shape)
    order = [int(a), int(b)]
    partner = {int(b): int(a)}
    best = np.maximum(sym[a], sym[b])
    best_from = np.where(sym[b] > sym[a], b, a).astype(np.int64)
    best[[a, b]] = -1
    for _ in range(F - 2):
        u = int(np.argmax(best))
        order.append(u)
        partner[u] = int(best_from[u])
        upd = sym[u] > best
        best_from = np.where(upd, u, best_from)
        best = np.maximum(best, sym[u])
        best[u] = -1
        best[order] = -1
    return order, partner


def select_covisible_pairs(table: torch.Tensor, min_count: int, min_gap: int = 1) -> torch.Tensor:
    """(F, F) bool mask of proposed pairs from a match-count table:
    upper-triangle pairs at least ``min_gap`` apart with at least
    ``min_count`` matches (the global-SfM pair shortlist / loop-candidate
    set). Elementwise."""
    i = torch.arange(table.shape[0], device=table.device)
    apart = (i[None, :] - i[:, None]) >= min_gap
    return apart & (table >= min_count)
