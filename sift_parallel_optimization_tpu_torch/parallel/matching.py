"""Pairwise keyframe matching for SfM pair selection (port of the
single-device part of ``parallel/matching.py``).

Global SfM pair selection needs the (F, F) table of pairwise match counts
over F keyframes. ``pairwise_match_counts`` computes it on one device, one
row of the table (frame a against all F frames) per batched product; the
ring-sharded ``ring_pairwise_match_counts`` of the JAX package waits for
``parallel/`` on ``torch.distributed``.
"""

from __future__ import annotations

import numpy as np
import torch

from sift_parallel_optimization_tpu_torch.core.pyramid_ref import check_fp32_matmul


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
    return torch.stack([_row_counts(descriptors[a], valid[a], descriptors, valid, ratio)
                        for a in range(descriptors.shape[0])])


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
