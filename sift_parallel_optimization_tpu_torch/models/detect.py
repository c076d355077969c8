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

:func:`detect_octave_groups_batched` is the one implementation, as in the
JAX package: groups of ``(octave_id, dog)`` octaves, each group one flat
score segment in group order. A group of one octave is NATIVE (its own
size; on the block-reduce branch the kernel's per-octave tables, every
native octave of every frame in one launch); a group of several shares one
zero-padded CANVAS, scored with PyTorch ops on the padded stack with the
padded voxels masked, its whole flat score row cut into 64-voxel blocks as
the JAX package cuts it (blocks straddle the members, so per-octave tables
could not select the same candidates; the JAX package computes this group
in XLA, not in its Pallas kernel). Every tensor carries a leading frame
axis, each kernel and each PyTorch op runs once for the whole batch, sorts
and top-k run along the last axis so ties break per frame, and nothing
mixes values across frames: a frame's keypoints do not depend on the batch
it is in. :func:`detect_pyramid_batched`, :func:`detect_pyramid`,
:func:`detect_octave_groups`, :func:`detect_octaves_batched` and
:func:`detect_octave` build groups and call it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sift_parallel_optimization_tpu_torch.config import PyramidConfig
from sift_parallel_optimization_tpu_torch.models.keypoints import Keypoints, stable_top_k
from sift_parallel_optimization_tpu_torch.ops import score_tables
from sift_parallel_optimization_tpu_torch.utils.profiling import span

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


# (grouping, device) -> the static metadata of one grouping of octave shapes.
_STATIC: dict[tuple, dict] = {}
# Columns of the per-member table (one row a group member, in group order).
_BASE, _HW, _HS, _WS, _WP, _SP, _GSTART, _LS, _LY, _LX, _OCT = range(11)


def _group_meta(key: tuple, device) -> dict:
    """Per-member and per-group metadata of a grouping on ``device``, built
    once. ``key`` holds, per group, its members' (octave id, (S+2, H, W)).

    Members' flat score bases step by the group's canvas interior ((S) *
    (hp-2) * (wp-2) voxels; a native group's canvas is its octave), their
    unravel strides are the canvas', their hop limits their own interiors'.
    ``tab`` packs a member's columns (one gather a call), ``deltas`` its 19
    fit offsets in the flat DoG. The native octaves, in group order, are
    kernel 3's octaves: ``lay`` is their table layout and ``shift`` moves
    the kernel's flat indices (which count native octaves only) to the
    grouping's (None where they agree)."""
    ck = (key, str(device))
    if ck in _STATIC:
        return _STATIC[ck]
    ds2 = key[0][0][1][0]
    natives = tuple(shape for grp in key if len(grp) == 1 for _o, shape in grp)
    lay = score_tables.table_layout(natives) if natives else []
    rows, groups, base, gstart, j = [], [], 0, 0, 0
    for grp in key:
        hp = max(h for _o, (_p, h, _w) in grp)
        wp = max(w for _o, (_p, _h, w) in grp)
        v = (ds2 - 2) * (hp - 2) * (wp - 2)
        for jj, (o, (_p, h, w)) in enumerate(grp):
            rows.append((base + jj * v, (hp - 2) * (wp - 2), hp - 2, wp - 2, wp, hp * wp,
                         gstart + jj * ds2 * hp * wp, ds2 - 3, h - 3, w - 3, o))
        g = {"base": base, "vg": len(grp) * v, "canvas": (hp, wp), "native": None}
        if len(grp) == 1:
            g["native"], j = j, j + 1
        elif any(shape[1:] != (hp, wp) for _o, shape in grp):
            iy = torch.arange(hp - 2, device=device)[:, None]
            ix = torch.arange(wp - 2, device=device)[None, :]
            g["inside"] = torch.stack([(iy < h - 2) & (ix < w - 2)
                                       for _o, (_p, h, w) in grp])[None, :, None]
        groups.append(g)
        base += len(grp) * v
        gstart += len(grp) * ds2 * hp * wp
    meta = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    tab = meta(rows)
    fit = meta(list(_FIT_OFFSETS))
    st = {"groups": groups, "n_total": base, "lay": lay, "natives": natives,
          "bases": tab[:, _BASE].contiguous(), "tab": tab,
          "deltas": (fit[:, 0] * tab[:, _SP, None] + fit[:, 1] * tab[:, _WP, None] + fit[:, 2]),
          "shift": None, "tables": {},
          # The sources are kernel 3's entries, then each canvas group's: in
          # group order unless a native group follows a canvas group.
          "moved": any(a["native"] is None and c["native"] is not None
                       for a, c in zip(groups, groups[1:]))}
    if lay:
        shift = torch.zeros(lay[-1].out_off + lay[-1].n, dtype=torch.int64)
        for g in groups:
            if g["native"] is not None:
                o = lay[g["native"]]
                shift[o.out_off:o.out_off + o.n] = g["base"] - o.g_base
        st["shift"] = shift.to(device) if bool(shift.any()) else None
        dense = [(jn, o) for jn, o in enumerate(lay) if o.dense]
        if dense:
            st["dense_grp"] = meta([jn for jn, o in dense for _ in range(o.vg)])
            st["dense_pos"] = torch.cat([
                torch.arange(o.out_off, o.out_off + o.vg, device=device) for _, o in dense
            ])
    _STATIC[ck] = st
    return st


def _arange(st: dict, start: int, n: int) -> torch.Tensor:
    """A cached (n,) arange from ``start`` on the grouping's device."""
    key = (start, n)
    if key not in st["tables"]:
        st["tables"][key] = torch.arange(start, start + n, device=st["tab"].device)
    return st["tables"][key]


def _canvas_scores(dogs, g: dict, thr: float, edge_ratio: float, refine_iters: int,
                   want_keys: bool):
    """A canvas group's members zero-padded to its (hp, wp) canvas and scored
    as one (B * n_g, S+2, hp, wp) stack, the voxels outside each member's
    interior set to 0. Returns (B, V_g) f32 scores, (B, V_g) int32 ranking
    keys (hop-packed for refine_iters >= 1, else the score's bits; None
    unless ``want_keys``) and the (B, n_g * (S+2) * hp * wp) flat stack."""
    hp, wp = g["canvas"]
    b, ds2 = dogs[0].shape[:2]
    stack = torch.stack([F.pad(d.to(torch.float32), (0, wp - d.shape[3], 0, hp - d.shape[2]))
                         for d in dogs], dim=1)                     # (B, n_g, S+2, hp, wp)
    flat = stack.reshape(-1, ds2, hp, wp)
    key = None
    if want_keys and refine_iters:
        score, key = dense_score(flat, thr, edge_ratio, refine_iters, want_hops=True)
    else:
        score = dense_score(flat, thr, edge_ratio, refine_iters)
        if want_keys:
            key = score.view(torch.int32)
    if "inside" in g:
        shp = (b, len(dogs), *score.shape[1:])
        score = torch.where(g["inside"], score.view(shp), 0.0)
        if key is not None:
            key = torch.where(g["inside"], key.view(shp), 0)
    return (score.reshape(b, -1), None if key is None else key.reshape(b, -1),
            stack.reshape(b, -1))


def _canvas_entries(score, key, g: dict, k: int):
    """A canvas group's candidate entries on the block-reduce branch, as the
    JAX package forms them: per 64-voxel block of its whole flat row the
    top-2 keys (``score_tables.block_top2``, first-index ties), or, under
    ``DENSE_BELOW`` voxels, its top-min(k, V_g) voxels by f32 score (ties
    to the lower index) with their keys. Returns (B, n) int32 keys and
    int64 flat indices."""
    vg, b = g["vg"], score.shape[0]
    if vg < score_tables.DENSE_BELOW:
        _top, sel = stable_top_k(score, min(k, vg))
        return torch.gather(key, 1, sel), g["base"] + sel
    span = score_tables.SPAN
    nblk = -(-vg // span)
    rows = F.pad(key, (0, nblk * span - vg)).view(b * nblk, span)
    v1, a1, v2, a2 = (t.view(b, nblk) for t in score_tables.block_top2(rows))
    rbase = span * torch.arange(nblk, device=score.device)
    idx = torch.clamp(torch.cat([rbase + a1, rbase + a2], dim=-1), max=vg - 1)
    return torch.cat([v1, v2], dim=-1), g["base"] + idx


def _select_block_reduce(tables, canvas, st: dict, k: int, b: int):
    """The JAX package's extraction over the candidate entries, per frame of
    the (B,) axis: each group's part in group order -- a native octave's
    [firsts, seconds] tables (kernel 3's ``tables`` = (keys, indices, dense
    scores)) or, under 4096 voxels, its exact top-min(k, vg) by f32 score
    (ties to the lower index); a canvas group's ``canvas`` entries -- then
    zero-padded to k and ONE stable top-k (ties to the lower position).
    Returns (B, k) int32 keys and int64 indices."""
    srcs_v, srcs_i, lay = [], [], st["lay"]
    if tables is not None:
        tv, ti, tscore = tables
        srcs_v.append(tv)
        srcs_i.append(ti if st["shift"] is None else ti + st["shift"])
    srcs_v += [v for v, _i in canvas]
    srcs_i += [i for _v, i in canvas]
    vals = srcs_v[0] if len(srcs_v) == 1 else torch.cat(srcs_v, dim=-1)
    idx = srcs_i[0] if len(srcs_i) == 1 else torch.cat(srcs_i, dim=-1)
    groups = st["groups"]
    if "dense_pos" in st or st["moved"]:
        perm = None
        if "dense_pos" in st:
            # Group the dense octaves' voxels by octave, score descending
            # within each: two stable sorts.
            order = torch.sort(tscore, dim=-1, descending=True, stable=True).indices
            by_group = torch.sort(st["dense_grp"][order], dim=-1, stable=True).indices
            perm = st["dense_pos"][torch.gather(order, -1, by_group)]
        pieces, at, parts = [], lay[-1].out_off + lay[-1].n if lay else 0, iter(canvas)
        for g in groups:
            if g["native"] is None:
                n = next(parts)[0].shape[-1]
                pieces.append(_arange(st, at, n))
                at += n
                continue
            o = lay[g["native"]]
            pieces.append(perm[:, o.score_off:o.score_off + min(k, o.vg)] if o.dense
                          else _arange(st, o.out_off, o.n))
        full = torch.cat([p.expand(b, -1) for p in pieces], dim=-1)
        vals, idx = torch.gather(vals, -1, full), torch.gather(idx, -1, full)
    if len(groups) == 1 and vals.shape[-1] == k:
        return vals, idx
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = torch.cat([vals, vals.new_zeros((b, pad))], dim=-1)
        idx = torch.cat([idx, idx.new_zeros((b, pad))], dim=-1)
    top, sel = stable_top_k(vals, k)
    return top, torch.gather(idx, -1, sel)


def detect_octave_groups_batched(
    groups: list[list[tuple[int, torch.Tensor]]],
    cfg: PyramidConfig,
    capacity: int,
    contrast_threshold: float = CONTRAST_THRESHOLD,
    edge_ratio: float = EDGE_RATIO,
    refine_iters: int = 1,
    use_approx_topk: bool | None = None,
    adaptive_hop: bool = False,
) -> Keypoints:
    """Groups of ``(octave_id, dog)`` octaves, ``dog`` (B, S+2, H, W) -> (B,
    ``capacity``) keypoint slots, each frame's slots shared across all its
    octaves (one top-k by ranking score). Any number of groups, of members
    of any size, in any order; a member's coordinates and sigma are scaled
    by 2^octave_id. A group of one octave keeps its size; the members of a
    larger group are zero-padded to one canvas and their padded voxels
    masked out of the candidates (module docstring).

    ``use_approx_topk`` picks the selection branch: None means block-reduce
    on a CUDA tensor (native groups through kernel 3) and exact on the CPU.
    ``adaptive_hop`` adds one more hop-and-refit round for candidates whose
    last fit still escapes the trust region; converged candidates keep their
    values (computed for all, then selected: no host sync).

    Its three parts run in the sub-spans ``sift.detect.score`` (canvases,
    dense scores, kernel 3), ``sift.detect.select`` (selection, padding, the
    winners' decode) and ``sift.detect.refit`` (``utils/profiling.span``).
    """
    if not groups or not all(groups):
        raise ValueError("expected at least one non-empty group of (octave_id, dog)")
    b, ds2 = groups[0][0][1].shape[:2]
    if any(d.dim() != 4 or tuple(d.shape[:2]) != (b, ds2) for grp in groups for _o, d in grp):
        raise ValueError("expected (B, S+2, H_o, W_o) DoG tensors with one B and one S")
    device = groups[0][0][1].device
    if use_approx_topk is None:
        use_approx_topk = device.type == "cuda"
    use_hops = use_approx_topk and refine_iters >= 1
    st = _group_meta(tuple(tuple((int(o), tuple(d.shape[1:])) for o, d in grp)
                           for grp in groups), device)
    k = min(capacity, st["n_total"])
    thr = contrast_threshold / cfg.S
    with span("sift.detect.score"):
        native = [grp[0][1].to(torch.float32).reshape(b, -1) for grp in groups if len(grp) == 1]
        flat_native = ((native[0] if len(native) == 1 else torch.cat(native, dim=1)) if native
                       else None)
        pieces, scores, canvas = [], [], []
        for grp, g in zip(groups, st["groups"]):
            if g["native"] is not None:
                pieces.append(native[g["native"]])
                if not use_approx_topk:
                    scores.append(dense_score(grp[0][1], thr, edge_ratio,
                                              refine_iters).reshape(b, -1))
                continue
            score, key, stack = _canvas_scores([d for _o, d in grp], g, thr, edge_ratio,
                                               refine_iters, use_approx_topk)
            pieces.append(stack)
            if use_approx_topk:
                canvas.append(_canvas_entries(score, key, g, k))
            else:
                scores.append(score)
        # (B, L): each frame's groups back to back, frame-major.
        flat_dog = flat_native if len(pieces) == len(native) else torch.cat(pieces, dim=1)
        tables = None
        if use_approx_topk and flat_native is not None:
            tables = score_tables.score_block_top2(flat_native, st["natives"], thr, edge_ratio,
                                                   refine_iters)
    with span("sift.detect.select"):
        if use_approx_topk:
            vals, idx = _select_block_reduce(tables, canvas, st, k, b)
        else:
            vals, idx = stable_top_k(scores[0] if len(scores) == 1 else torch.cat(scores, dim=1),
                                     k)
        if k < capacity:  # tiny pyramid: pad up to capacity
            pad = capacity - k
            vals = torch.cat([vals, vals.new_zeros((b, pad))], dim=-1)
            idx = torch.cat([idx, idx.new_zeros((b, pad))], dim=-1)
        if use_approx_topk:
            # One decode of the winners: hop code from the low 5 bits, the f32
            # score from the rest (packed 0 -> 0.0, so invalid slots stay so).
            if use_hops:
                hops = (vals & 31).to(torch.int64)
                vals = vals & ~31
            vals = vals.view(torch.float32)

    with span("sift.detect.refit"):
        # Each slot's member (bases ascend in group order) and its metadata in
        # one gather of the packed table.
        j = (idx[..., None] >= st["bases"]).sum(-1) - 1
        col = st["tab"][j].unbind(-1)
        wp_c, sp_c, lim_s, lim_y, lim_x = col[_WP], col[_SP], col[_LS], col[_LY], col[_LX]
        rem = idx - col[_BASE]
        s_i = rem // col[_HW]
        y_i = (rem // col[_WS]) % col[_HS]
        x_i = rem % col[_WS]
        deltas = st["deltas"][j]                                # (B, K, 19)
        corner0 = col[_GSTART]

        def fit_at(ps, py, px):
            corner = corner0 + ps * sp_c + py * wp_c + px
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
        oct_ids = col[_OCT].to(torch.int32)
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


def detect_octave_groups(groups: list[list[tuple[int, torch.Tensor]]], cfg: PyramidConfig,
                         capacity: int, **thresholds) -> Keypoints:
    """Groups of ``(octave_id, dog)`` with ``dog`` (S+2, H, W) -> ``capacity``
    slots shared across all octaves: the B = 1 case of
    :func:`detect_octave_groups_batched`, which documents ``thresholds``."""
    kp = detect_octave_groups_batched([[(o, d[None]) for o, d in grp] for grp in groups], cfg,
                                      capacity, **thresholds)
    return Keypoints(*[f[0] for f in kp])


def detect_octaves_batched(dogs: list[torch.Tensor], octaves: list[int], cfg: PyramidConfig,
                           capacity: int, **thresholds) -> Keypoints:
    """(S+2, H_i, W_i) DoG stacks of the given octave ids -> ``capacity``
    shared slots: :func:`detect_octave_groups` with every octave in ONE
    padded group."""
    return detect_octave_groups([list(zip(octaves, dogs))], cfg, capacity, **thresholds)


def _pyramid_groups(dogs, tail_batch_side: int | None) -> list:
    """The JAX package's grouping of a pyramid: every octave at its native
    size, one group each; with ``tail_batch_side``, the octaves whose long
    side is at most that share one zero-padded canvas group, last."""
    small = lambda d: tail_batch_side is not None and max(d.shape[-2:]) <= tail_batch_side
    tail = [(o, d) for o, d in enumerate(dogs) if small(d)]
    return [[(o, d)] for o, d in enumerate(dogs) if not small(d)] + ([tail] if tail else [])


def detect_pyramid_batched(
    dogs: list[torch.Tensor],
    cfg: PyramidConfig,
    max_keypoints: int = 512,
    tail_batch_side: int | None = None,
    **thresholds,
) -> Keypoints:
    """One (B, S+2, H_o, W_o) DoG tensor per octave -> Keypoints with a
    leading (B,) axis, ``max_keypoints`` slots per frame shared across the
    frame's octaves, equal slot for slot to :func:`detect_pyramid` of each
    frame: :func:`detect_octave_groups_batched` with one native group an
    octave. ``tail_batch_side``: octaves whose long side is at most this
    share one zero-padded canvas group instead (the JAX package's study
    knob, off by default there too); the selection is the native one's but
    for ties, which the canvas' flat order breaks as the JAX package's does.
    """
    return detect_octave_groups_batched(_pyramid_groups(dogs, tail_batch_side), cfg,
                                        max_keypoints, **thresholds)


def detect_pyramid(dogs: list[torch.Tensor], cfg: PyramidConfig, max_keypoints: int = 512,
                   tail_batch_side: int | None = None, **thresholds) -> Keypoints:
    """(S+2, H_o, W_o) DoG octaves of one frame -> ``max_keypoints`` slots
    shared across all octaves: :func:`detect_octave_groups` with the
    grouping of :func:`detect_pyramid_batched`."""
    return detect_octave_groups(_pyramid_groups(dogs, tail_batch_side), cfg, max_keypoints,
                                **thresholds)


def detect_octave(dog: torch.Tensor, octave: int, cfg: PyramidConfig, capacity: int,
                  contrast_threshold: float = CONTRAST_THRESHOLD, edge_ratio: float = EDGE_RATIO,
                  refine_iters: int = 1) -> Keypoints:
    """(S+2, H, W) DoG stack of ONE octave -> Keypoints with ``capacity``
    slots, coordinates and sigma in original image units (scaled by
    2^octave), ``octave`` in every slot: :func:`detect_octaves_batched` of
    this octave alone, as in the JAX package."""
    return detect_octaves_batched([dog], [octave], cfg, capacity,
                                  contrast_threshold=contrast_threshold,
                                  edge_ratio=edge_ratio, refine_iters=refine_iters)
