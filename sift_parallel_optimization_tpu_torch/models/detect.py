"""DoG extrema detection (port of ``models/detect.py``).

A dense per-voxel ranking score over every octave (strict 26-neighbour
extremum, Brown & Lowe quadratic fit via closed-form 3x3 adjugate, Lowe's
edge test, refined contrast), a fixed-capacity selection of ``max_keypoints``
candidates across all octaves, then a sparse re-fit of the selected
candidates from their gathered 3x3x3 DoG neighbourhoods with one-voxel
refinement hops. Same expressions in the same order as the JAX functions,
so CPU results agree to the last bits on the same DoG input.

Two selection branches, as in the JAX package (``use_approx_topk``):

* exact (the default on the CPU): the dense score volume, then ONE stable
  top-k over the concatenated octaves, ties to the lower flat index;
* block-reduce (the default on the card): the score never reaches memory.
  Kernel ``ops/score_tables`` writes per flat 64-voxel block the top-2 of
  the score with the first refinement hop packed into its low mantissa bits
  (every voxel of an octave under 4096 voxels); one selection over those
  tables picks the candidates, and the sparse re-fit starts at the hopped
  voxel. The JAX package's ``approx_max_k`` is exact on the CPU and exact
  selection is a valid ``approx_max_k``, so the port selects exactly.

:func:`detect_pyramid_batched` is the one implementation: every tensor
carries a leading frame axis, each kernel and each PyTorch op runs once for
the whole batch (the block-reduce kernel takes every octave of every frame
in one launch, sorts and top-k run along the last axis so ties break per
frame), and :func:`detect_pyramid` is its B = 1 case. Nothing mixes values
across frames, so a frame's keypoints do not depend on the batch it is in.
"""

from __future__ import annotations

import torch

from sift_parallel_optimization_tpu_torch.config import PyramidConfig
from sift_parallel_optimization_tpu_torch.models.keypoints import Keypoints, stable_top_k
from sift_parallel_optimization_tpu_torch.ops import score_tables

CONTRAST_THRESHOLD = 0.04
EDGE_RATIO = 10.0
MAX_REFINE_OFFSET = 0.6


def _window_extrema(dog: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D, H, W) -> bool (..., D-2, H-2, W-2): strict 26-neighbour max /
    min (separable shifted-slice max/min, centre included in the window)."""

    def m3(x, axis, op):
        n = x.shape[axis]
        return op(op(x.narrow(axis, 0, n - 2), x.narrow(axis, 1, n - 2)),
                  x.narrow(axis, 2, n - 2))

    mx = mn = dog
    for axis in (-3, -2, -1):
        mx = m3(mx, axis, torch.maximum)
        mn = m3(mn, axis, torch.minimum)
    c = dog[..., 1:-1, 1:-1, 1:-1]
    return c >= mx, c <= mn


def _grad_hess(dog: torch.Tensor):
    """Central differences at interior voxels of (..., D, H, W): g = (gs, gy,
    gx) and H = (hss, hyy, hxx, hsy, hsx, hyx), each (..., D-2, H-2, W-2)."""
    c = dog[..., 1:-1, 1:-1, 1:-1]
    ds_p, ds_m = dog[..., 2:, 1:-1, 1:-1], dog[..., :-2, 1:-1, 1:-1]
    dy_p, dy_m = dog[..., 1:-1, 2:, 1:-1], dog[..., 1:-1, :-2, 1:-1]
    dx_p, dx_m = dog[..., 1:-1, 1:-1, 2:], dog[..., 1:-1, 1:-1, :-2]
    gs, gy, gx = (ds_p - ds_m) / 2, (dy_p - dy_m) / 2, (dx_p - dx_m) / 2
    hss = ds_p + ds_m - 2 * c
    hyy = dy_p + dy_m - 2 * c
    hxx = dx_p + dx_m - 2 * c
    hsy = (dog[..., 2:, 2:, 1:-1] - dog[..., 2:, :-2, 1:-1]
           - dog[..., :-2, 2:, 1:-1] + dog[..., :-2, :-2, 1:-1]) / 4
    hsx = (dog[..., 2:, 1:-1, 2:] - dog[..., 2:, 1:-1, :-2]
           - dog[..., :-2, 1:-1, 2:] + dog[..., :-2, 1:-1, :-2]) / 4
    hyx = (dog[..., 1:-1, 2:, 2:] - dog[..., 1:-1, 2:, :-2]
           - dog[..., 1:-1, :-2, 2:] + dog[..., 1:-1, :-2, :-2]) / 4
    return (gs, gy, gx), (hss, hyy, hxx, hsy, hsx, hyx)


def _edge_test(hyy, hxx, hyx, edge_ratio):
    """Lowe's 2-D edge-response test on the spatial Hessian."""
    tr = hxx + hyy
    det2 = hxx * hyy - hyx * hyx
    return (det2 > 0) & (tr * tr * edge_ratio < (edge_ratio + 1) ** 2 * det2)


def _solve3(h, g):
    """Solve H @ off = -g for symmetric 3x3 H via the adjugate.
    Returns (off_s, off_y, off_x, det)."""
    a, d, f, b, c, e = h  # H = [[a,b,c],[b,d,e],[c,e,f]]
    gs, gy, gx = g
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    off_s = -(A * gs + B * gy + C * gx) * inv_det
    off_y = -(B * gs + D * gy + E * gx) * inv_det
    off_x = -(C * gs + E * gy + F * gx) * inv_det
    return off_s, off_y, off_x, det


def dense_score(
    dog: torch.Tensor,
    thr: float,
    edge_ratio: float,
    refine_iters: int,
    want_hops: bool = False,
):
    """(..., S+2, H, W) DoG -> (..., S, H-2, W-2) ranking score (0
    off-candidate) for the contrast threshold ``thr`` (already divided by S).

    ``want_hops`` (refine_iters >= 1 only) also returns the int32 key the
    block-reduce branch ranks by: the score's bit pattern (order-preserving
    for non-negative f32) with its 5 low bits replaced by the first
    refinement hop code, (st_s*9 + st_y*3 + st_x) for st = clip(round(off),
    -1, 1) + 1, or 13 where every |offset| <= MAX_REFINE_OFFSET; a score of
    0 stays exactly 0.
    """
    dog = dog.to(torch.float32)
    is_max, is_min = _window_extrema(dog)
    g, h = _grad_hess(dog)
    off_s, off_y, off_x, _ = _solve3(h, g)
    c = dog[..., 1:-1, 1:-1, 1:-1]
    gs, gy, gx = g
    _hss, hyy, hxx, _hsy, _hsx, hyx = h
    edge_ok = _edge_test(hyy, hxx, hyx, edge_ratio)
    zero = torch.zeros_like(c)
    m = MAX_REFINE_OFFSET
    if refine_iters:
        # Rank without the offset gate; clamp offsets to the trust region
        # so a near-singular Hessian cannot inflate the ranking contrast.
        d_rank = c + 0.5 * (
            gs * off_s.clamp(-m, m) + gy * off_y.clamp(-m, m) + gx * off_x.clamp(-m, m)
        )
        good = (is_max | is_min) & (d_rank.abs() > thr) & edge_ok
        score = torch.where(good, d_rank.abs(), zero)
        if not want_hops:
            return score
        conv = (off_s.abs() <= m) & (off_y.abs() <= m) & (off_x.abs() <= m)
        st = lambda o: torch.round(o).clamp(-1, 1).to(torch.int32) + 1
        hop = torch.where(conv, 13, st(off_s) * 9 + st(off_y) * 3 + st(off_x))
        bits = score.view(torch.int32)
        packed = torch.where(score > 0, (bits & ~31) | hop, 0)
        return score, packed
    if want_hops:
        raise ValueError("want_hops requires refine_iters >= 1")
    d_hat = c + 0.5 * (gs * off_s + gy * off_y + gx * off_x)
    off_ok = (off_s.abs() < m) & (off_y.abs() < m) & (off_x.abs() < m)
    good = (is_max | is_min) & (d_hat.abs() > thr) & edge_ok & off_ok
    return torch.where(good, d_hat.abs(), zero)


# The 19 voxels of a 3x3x3 neighbourhood the quadratic fit reads (centre,
# 6 faces, 12 edges), as (ds, dy, dx) offsets from the cube corner.
_FIT_OFFSETS = tuple(
    (ds, dy, dx)
    for ds in range(3) for dy in range(3) for dx in range(3)
    if (ds != 1) + (dy != 1) + (dx != 1) <= 2
)


def _cube_fit(vals19: torch.Tensor, edge_ratio: float):
    """Sparse Brown & Lowe re-fit on gathered (..., 19) neighbourhoods laid
    out per :data:`_FIT_OFFSETS`; the dense stage's expressions, so values
    equal the dense fields. Returns (off_s, off_y, off_x, d_hat, edge_ok)."""
    v = {off: vals19[..., i] for i, off in enumerate(_FIT_OFFSETS)}
    c = v[1, 1, 1]
    ds_p, ds_m = v[2, 1, 1], v[0, 1, 1]
    dy_p, dy_m = v[1, 2, 1], v[1, 0, 1]
    dx_p, dx_m = v[1, 1, 2], v[1, 1, 0]
    gs, gy, gx = (ds_p - ds_m) / 2, (dy_p - dy_m) / 2, (dx_p - dx_m) / 2
    hss = ds_p + ds_m - 2 * c
    hyy = dy_p + dy_m - 2 * c
    hxx = dx_p + dx_m - 2 * c
    hsy = (v[2, 2, 1] - v[2, 0, 1] - v[0, 2, 1] + v[0, 0, 1]) / 4
    hsx = (v[2, 1, 2] - v[2, 1, 0] - v[0, 1, 2] + v[0, 1, 0]) / 4
    hyx = (v[1, 2, 2] - v[1, 2, 0] - v[1, 0, 2] + v[1, 0, 0]) / 4
    g = (gs, gy, gx)
    off_s, off_y, off_x, _ = _solve3((hss, hyy, hxx, hsy, hsx, hyx), g)
    d_hat = c + 0.5 * (gs * off_s + gy * off_y + gx * off_x)
    return off_s, off_y, off_x, d_hat, _edge_test(hyy, hxx, hyx, edge_ratio)


# (shapes, device) -> the static index tensors of one pyramid shape.
_STATIC: dict[tuple, dict] = {}


def _static(shapes: tuple, device) -> dict:
    """Per-octave metadata of a pyramid shape on ``device``, built once:
    flat score bases, interior dims, hop limits, DoG starts, fit offsets,
    and the positions the block-reduce selection gathers from."""
    key = (shapes, str(device))
    if key in _STATIC:
        return _STATIC[key]
    lay = score_tables.table_layout(shapes)
    meta = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    st = {
        "lay": lay,
        "base": meta([o.g_base for o in lay]),
        "hs": meta([o.h - 2 for o in lay]),
        "ws": meta([o.w - 2 for o in lay]),
        "ly": meta([o.h - 3 for o in lay]),
        "lx": meta([o.w - 3 for o in lay]),
        "n_total": sum((p - 2) * (h - 2) * (w - 2) for p, h, w in shapes),
        "gstart": meta([o.dog_off for o in lay]),
        "fit": meta(list(_FIT_OFFSETS)),                     # (19, 3)
    }
    dense = [(j, o) for j, o in enumerate(lay) if o.dense]
    if dense:
        st["dense_grp"] = meta([j for j, o in dense for _ in range(o.vg)])
        st["dense_pos"] = torch.cat([
            torch.arange(o.out_off, o.out_off + o.vg, device=device) for _, o in dense
        ])
    st["tables"] = {
        j: torch.arange(o.out_off, o.out_off + o.n, device=device)
        for j, o in enumerate(lay) if not o.dense
    }
    _STATIC[key] = st
    return st


def _select_from_tables(vals, idx, score, st: dict, k: int):
    """The JAX package's extraction over the block tables, per frame of the
    leading (B,) axis: each octave's part is its [firsts, seconds] tables or,
    for an octave under 4096 voxels, its exact top-min(k, vg) by f32 score
    (ties to the lower index); the parts concatenate in octave order,
    zero-pad to k and meet ONE stable top-k (ties to the lower position).
    Returns (B, k) int32 keys and int64 indices."""
    lay = st["lay"]
    b = vals.shape[0]
    if "dense_pos" in st:
        # Group by octave, score descending within it: two stable sorts.
        order = torch.sort(score, dim=-1, descending=True, stable=True).indices
        by_group = torch.sort(st["dense_grp"][order], dim=-1, stable=True).indices
        perm = st["dense_pos"][torch.gather(order, -1, by_group)]
        full = torch.cat([
            perm[:, o.score_off:o.score_off + min(k, o.vg)] if o.dense
            else st["tables"][j].expand(b, -1)
            for j, o in enumerate(lay)
        ], dim=-1)
        vals, idx = torch.gather(vals, -1, full), torch.gather(idx, -1, full)
    if len(lay) == 1 and vals.shape[-1] == k:
        return vals, idx
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = torch.cat([vals, vals.new_zeros((b, pad))], dim=-1)
        idx = torch.cat([idx, idx.new_zeros((b, pad))], dim=-1)
    top, sel = stable_top_k(vals, k)
    return top, torch.gather(idx, -1, sel)


def _tail_canvas(shapes: tuple, tail: int, device) -> dict:
    """Per-octave metadata of the exact branch when octaves ``tail:`` share
    one zero-padded canvas (the JAX package's ``tail_batch_side`` group):
    the canvas members' flat score bases step by a canvas' interior, their
    strides are the canvas' and their hop limits their own interiors. The
    big octaves keep :func:`_static`'s values. Built once a (shapes, tail,
    device)."""
    key = ("tail", shapes, tail, str(device))
    if key in _STATIC:
        return _STATIC[key]
    big, members = shapes[:tail], shapes[tail:]
    ds2 = shapes[0][0]
    hp, wp = max(h for _, h, _w in members), max(w for _, _h, w in members)
    base = sum((p - 2) * (h - 2) * (w - 2) for p, h, w in big)
    dog = sum(p * h * w for p, h, w in big)
    v = (ds2 - 2) * (hp - 2) * (wp - 2)
    rows = [(sum((p - 2) * (h - 2) * (w - 2) for p, h, w in big[:o]),
             h - 2, w - 2, sum(p * hh * ww for p, hh, ww in big[:o]), h - 3, w - 3)
            for o, (p, h, w) in enumerate(big)]
    rows += [(base + j * v, hp - 2, wp - 2, dog + j * ds2 * hp * wp, h - 3, w - 3)
             for j, (_p, h, w) in enumerate(members)]
    cols = list(zip(*rows))
    meta = {name: torch.tensor(c, dtype=torch.int64, device=device)
            for name, c in zip(("base", "hs", "ws", "gstart", "ly", "lx"), cols)}
    meta.update(canvas=(hp, wp), n_total=base + len(members) * v,
                inside=[(h - 2, w - 2) for _p, h, w in members])
    _STATIC[key] = meta
    return meta


def _tail_scores(dogs: list[torch.Tensor], meta: dict, thr: float, edge_ratio: float,
                 refine_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The canvas group: (B, n_g * (S) * (hp-2) * (wp-2)) dense scores with
    the padded voxels zeroed, and its (B, n_g * (S+2) * hp * wp) flat DoG."""
    hp, wp = meta["canvas"]
    b, ds2 = dogs[0].shape[:2]
    stack = torch.stack([torch.nn.functional.pad(d.to(torch.float32),
                                                 (0, wp - d.shape[3], 0, hp - d.shape[2]))
                         for d in dogs], dim=1)                    # (B, n_g, S+2, hp, wp)
    score = dense_score(stack.reshape(-1, ds2, hp, wp), thr, edge_ratio, refine_iters)
    score = score.reshape(b, len(dogs), *score.shape[1:])          # (B, n_g, S, hp-2, wp-2)
    iy = torch.arange(hp - 2, device=score.device)
    ix = torch.arange(wp - 2, device=score.device)
    inside = torch.stack([(iy[:, None] < h) & (ix[None, :] < w) for h, w in meta["inside"]])
    score = torch.where(inside[None, :, None], score, torch.zeros_like(score))
    return score.reshape(b, -1), stack.reshape(b, -1)


def detect_pyramid_batched(
    dogs: list[torch.Tensor],
    cfg: PyramidConfig,
    max_keypoints: int = 512,
    contrast_threshold: float = CONTRAST_THRESHOLD,
    edge_ratio: float = EDGE_RATIO,
    refine_iters: int = 1,
    use_approx_topk: bool | None = None,
    adaptive_hop: bool = False,
    tail_batch_side: int | None = None,
) -> Keypoints:
    """One (B, S+2, H_o, W_o) DoG tensor per octave -> Keypoints with a
    leading (B,) axis: ``max_keypoints`` slots per frame, shared across the
    frame's octaves, equal slot for slot to :func:`detect_pyramid` of each
    frame.

    ``use_approx_topk`` picks the selection branch (module docstring); None
    means the block-reduce branch on a CUDA tensor and the exact one on the
    CPU. ``adaptive_hop`` adds one more hop-and-refit round for candidates
    whose last fit still escapes the trust region; converged candidates keep
    their values (computed for all, then selected: no host sync).

    ``tail_batch_side``: octaves whose longest side is at most this share
    one zero-padded canvas group, scored on the canvas with its padded
    voxels masked out (the JAX package's study knob, off by default there
    too); exact branch only. The selection is the native one's but for ties,
    which the canvas' flat order breaks as the JAX package's does.
    """
    device = dogs[0].device
    b, ds2 = dogs[0].shape[:2]
    if any(d.dim() != 4 or d.shape[0] != b for d in dogs):
        raise ValueError("expected one (B, S+2, H_o, W_o) DoG tensor per octave")
    if use_approx_topk is None:
        use_approx_topk = device.type == "cuda"
    use_hops = use_approx_topk and refine_iters >= 1
    shapes = tuple(tuple(d.shape[1:]) for d in dogs)
    tail = next((o for o, (_p, h, w) in enumerate(shapes)
                 if tail_batch_side is not None and max(h, w) <= tail_batch_side), len(shapes))
    if any(max(h, w) > tail_batch_side for _p, h, w in shapes[tail:]):
        raise ValueError("tail_batch_side: the octaves that share the canvas must be the last")
    if tail < len(shapes) and use_approx_topk:
        raise ValueError("tail_batch_side groups octaves on the exact branch only "
                         "(use_approx_topk=False)")
    st = _static(shapes, device)
    meta = _tail_canvas(shapes, tail, device) if tail < len(shapes) else st
    k = min(max_keypoints, meta["n_total"])
    # (B, L): each frame's octaves back to back, frame-major.
    flat_dog = torch.cat([d.to(torch.float32).reshape(b, -1) for d in dogs[:tail]]
                         or [dogs[0].new_zeros((b, 0), dtype=torch.float32)], dim=1)
    thr = contrast_threshold / cfg.S
    if use_approx_topk:
        tv, ti, tscore = score_tables.score_block_top2(
            flat_dog, shapes, thr, edge_ratio, refine_iters
        )
        vals, idx = _select_from_tables(tv, ti, tscore, st, k)
    else:
        scores = [dense_score(d, thr, edge_ratio, refine_iters).reshape(b, -1)
                  for d in dogs[:tail]]
        if tail < len(shapes):
            tail_score, tail_dog = _tail_scores(dogs[tail:], meta, thr, edge_ratio,
                                                refine_iters)
            scores.append(tail_score)
            flat_dog = torch.cat([flat_dog, tail_dog], dim=1)
        vals, idx = stable_top_k(torch.cat(scores, dim=1), k)
    if k < max_keypoints:  # tiny pyramid: pad up to capacity
        pad = max_keypoints - k
        vals = torch.cat([vals, vals.new_zeros((b, pad))], dim=-1)
        idx = torch.cat([idx, idx.new_zeros((b, pad))], dim=-1)
    if use_approx_topk:
        # One decode of the winners: hop code from the low 5 bits, the f32
        # score from the rest (packed 0 -> 0.0, so invalid slots stay so).
        if use_hops:
            hops = (vals & 31).to(torch.int64)
            vals = vals & ~31
        vals = vals.view(torch.float32)

    bases = meta["base"]
    j = (idx[..., None] >= bases).sum(-1) - 1            # octave of each slot
    hs_c, ws_c = meta["hs"][j], meta["ws"][j]
    gstart_c = meta["gstart"][j]
    lim_y, lim_x = meta["ly"][j], meta["lx"][j]         # = H-3, W-3 of the octave
    lim_s = torch.full_like(hs_c, ds2 - 3)
    rem = idx - bases[j]
    s_i = rem // (hs_c * ws_c)
    y_i = (rem // ws_c) % hs_c
    x_i = rem % ws_c

    wp_c = ws_c + 2
    sp_c = (hs_c + 2) * wp_c
    fit = st["fit"]
    deltas = fit[:, 0] * sp_c[..., None] + fit[:, 1] * wp_c[..., None] + fit[:, 2]

    def fit_at(ps, py, px):
        corner = gstart_c + ps * sp_c + py * wp_c + px
        pos = (corner[..., None] + deltas).reshape(b, -1)
        return _cube_fit(torch.gather(flat_dog, 1, pos).view(b, -1, len(_FIT_OFFSETS)),
                         edge_ratio)

    def hop(p, o, lim, conv):
        step = torch.round(o).clamp(-1, 1).to(torch.int64)
        return torch.where(conv, p, torch.minimum(torch.clamp(p + step, min=0), lim))

    m = MAX_REFINE_OFFSET
    if use_hops:
        # The first hop was decided densely and rides the tables: start
        # there (code 13 = no hop decodes to steps (0, 0, 0)).
        ps = torch.minimum(torch.clamp(s_i + (hops // 9 - 1), min=0), lim_s)
        py = torch.minimum(torch.clamp(y_i + ((hops // 3) % 3 - 1), min=0), lim_y)
        px = torch.minimum(torch.clamp(x_i + (hops % 3 - 1), min=0), lim_x)
        rounds_left = refine_iters - 1
    else:
        ps, py, px = s_i, y_i, x_i
        rounds_left = refine_iters
    os_, oy, ox, dh, eok = fit_at(ps, py, px)
    if refine_iters:
        for _ in range(rounds_left):
            conv = (os_.abs() <= m) & (oy.abs() <= m) & (ox.abs() <= m)
            ps = hop(ps, os_, lim_s, conv)
            py = hop(py, oy, lim_y, conv)
            px = hop(px, ox, lim_x, conv)
            os_, oy, ox, dh, eok = fit_at(ps, py, px)
        if adaptive_hop:
            # Zero-score slots count as converged.
            conv = ((os_.abs() <= m) & (oy.abs() <= m) & (ox.abs() <= m)) | (vals <= 0)
            ps2 = hop(ps, os_, lim_s, conv)
            py2 = hop(py, oy, lim_y, conv)
            px2 = hop(px, ox, lim_x, conv)
            new = fit_at(ps2, py2, px2)
            ps, py, px = (torch.where(conv, a, b) for a, b in ((ps, ps2), (py, py2), (px, px2)))
            os_, oy, ox, dh, eok = (
                torch.where(conv, a, b) for a, b in zip((os_, oy, ox, dh, eok), new)
            )
        s_i, y_i, x_i = ps, py, px
        off_ok = (os_.abs() < m) & (oy.abs() < m) & (ox.abs() < m)
        valid = (vals > 0) & off_ok & eok & (dh.abs() > thr)
        vals = torch.where(valid, dh.abs(), torch.zeros_like(dh))
    else:
        valid = vals > 0

    x_o = x_i.to(torch.float32) + 1.0 + ox
    y_o = y_i.to(torch.float32) + 1.0 + oy
    s_o = s_i.to(torch.float32) + 1.0 + os_     # DoG plane index (1..S)
    oct_ids = j.to(torch.int32)
    scale_mult = torch.exp2(oct_ids.to(torch.float32))
    sigma = cfg.sigma0 * torch.exp2(s_o / cfg.S) * scale_mult
    zero = torch.zeros_like(vals)
    return Keypoints(
        x=torch.where(valid, x_o * scale_mult, zero),
        y=torch.where(valid, y_o * scale_mult, zero),
        sigma=torch.where(valid, sigma, zero),
        score=vals,
        orientation=zero,
        octave=oct_ids,
        scale=(s_i + 1).to(torch.int32),
        valid=valid,
    )


def detect_pyramid(dogs: list[torch.Tensor], cfg: PyramidConfig, max_keypoints: int = 512,
                   **thresholds) -> Keypoints:
    """(S+2, H_o, W_o) DoG octaves of one frame -> ``max_keypoints`` slots
    shared across all octaves: the B = 1 case of
    :func:`detect_pyramid_batched`, which documents ``thresholds``."""
    kp = detect_pyramid_batched([d[None] for d in dogs], cfg, max_keypoints, **thresholds)
    return Keypoints(*[f[0] for f in kp])


def detect_octave(dog: torch.Tensor, octave: int, cfg: PyramidConfig, capacity: int,
                  contrast_threshold: float = CONTRAST_THRESHOLD, edge_ratio: float = EDGE_RATIO,
                  refine_iters: int = 1) -> Keypoints:
    """(S+2, H, W) DoG stack of ONE octave -> Keypoints with ``capacity``
    slots, coordinates and sigma in original image units (scaled by
    2^octave), ``octave`` in every slot. The exact selection branch of
    :func:`detect_pyramid` on this octave alone, rescaled: a power-of-two
    product is exact, so the result is that octave's detection bit for bit."""
    kp = detect_pyramid([dog], cfg, capacity, contrast_threshold=contrast_threshold,
                        edge_ratio=edge_ratio, refine_iters=refine_iters, use_approx_topk=False)
    mult = float(2 ** octave)
    return kp._replace(x=kp.x * mult, y=kp.y * mult, sigma=kp.sigma * mult,
                       octave=torch.full_like(kp.octave, octave))
