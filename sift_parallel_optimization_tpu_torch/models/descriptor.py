"""Orientation assignment + 128-d SIFT descriptors (port of
``models/descriptor.py``).

All octaves' Gaussian planes are packed into one f32 plane atlas with the
JAX package's layout (ROW_PAD/COL_PAD margins, patch origins aligned down to
8 rows and 128 columns), so atlas and patches compare element for element.
Default branch: one patch per keypoint from the gather kernel
(``ops/patch_gather``), then two batched hat-weight matrix products resample
it onto the axis-aligned orientation (18^2) and descriptor (26^2) grids.
With :data:`USE_FUSED_SAMPLING`, the fused kernel (``ops/gather_resample``)
samples both grids straight from the atlas and the patch never reaches
memory. Orientation follows in plain PyTorch; the descriptor histograms and
their normalisation, every orientation of every slot, in one launch of
``ops/descriptor_hist`` (its plain version on CPU tensors), all in fp32.

A batch of frames -- (B, S+3, H_o, W_o) octaves and keypoints with a leading
(B,) axis -- takes the same code: one (B, R, C) atlas written in place, ONE
launch of the batched gather for all B * K patches, and every per-keypoint
step on the folded (B * K, ...) axis, so no op is repeated per frame.
"""

from __future__ import annotations

import math

import torch

from sift_parallel_optimization_tpu_torch.models.keypoints import Keypoints
from sift_parallel_optimization_tpu_torch.ops.descriptor_hist import (
    DESC_BIN_SIGMA,
    DESC_GRID,
    DESC_WIDTH,
    descriptor_hist,
    grid_gradients,
)
from sift_parallel_optimization_tpu_torch.ops.gather_resample import gather_resample, resample
from sift_parallel_optimization_tpu_torch.ops.patch_gather import (
    extract_atlas_patches,
    extract_atlas_patches_batched,
)
from sift_parallel_optimization_tpu_torch.utils.profiling import span

N_ORI_BINS = 36
ORI_SIGMA_FACTOR = 1.5     # orientation window sigma = 1.5 * keypoint sigma
ORI_RADIUS_FACTOR = 3.0    # window radius = 3 * window sigma
ORI_GRID = 18              # samples per axis (16x16 usable gradients)

ATLAS_DTYPE = torch.float32
ROW_ALIGN = 8              # row alignment of patch origins (f32)
MAX_RADIUS = 52            # guaranteed in-patch sample radius (+1 bilinear)
ROW_PAD = 64               # top pad per octave band
COL_PAD = 128              # left pad per octave band
PATCH_ROWS = 128
PATCH_COLS = 256


def max_patch_radius(S: int, sigma0: float = 1.6) -> int:
    """Config-tight sample-radius bound: the largest refined scale is
    sigma0 * 2^((S + 0.6)/S) (0.6 = detect.MAX_REFINE_OFFSET)."""
    sig_max = sigma0 * 2.0 ** ((S + 0.6) / S)
    rad_d = DESC_BIN_SIGMA * sig_max * math.sqrt(2.0) * (DESC_WIDTH + 1) / 2
    rad_o = ORI_RADIUS_FACTOR * ORI_SIGMA_FACTOR * sig_max
    return min(MAX_RADIUS, int(math.ceil(max(rad_d, rad_o))) + 1)


def patch_rows_for(max_radius: int) -> int:
    """Patch rows: 2*(radius+1) + ROW_ALIGN slack, rounded to ROW_ALIGN."""
    need = 2 * (max_radius + 1) + ROW_ALIGN
    return min(PATCH_ROWS, -(-need // ROW_ALIGN) * ROW_ALIGN)


def _roundup(v: int, m: int) -> int:
    return (v + m - 1) // m * m


# (octave shapes, device) -> the atlas layout of one pyramid shape.
_ATLAS_STATIC: dict[tuple, dict] = {}


def _atlas_static(shapes: tuple, device) -> dict:
    """Atlas layout for octaves of (scales, H_o, W_o) ``shapes`` on
    ``device``, built once: the int32 index tables ``row_off``/``hprime``/
    ``wlim`` (per octave) and the atlas size ``n_rows`` x ``n_cols``."""
    key = (shapes, str(device))
    if key in _ATLAS_STATIC:
        return _ATLAS_STATIC[key]
    wlim = [_roundup(w, 128) for _s, _h, w in shapes]
    hprime = [2 * ROW_PAD + _roundup(h, ROW_ALIGN) for _s, h, _w in shapes]
    row_off, r = [], 0
    for (s, _h, _w), hp in zip(shapes, hprime):
        row_off.append(r)
        r += s * hp
    lay = {
        k: torch.tensor(v, dtype=torch.int32, device=device)
        for k, v in (("row_off", row_off), ("hprime", hprime), ("wlim", wlim))
    }
    lay.update(n_rows=r, n_cols=max(COL_PAD + wl + 128 for wl in wlim),
               rows=tuple(row_off), hp=tuple(hprime))
    _ATLAS_STATIC[key] = lay
    return lay


def build_atlas(gauss_octaves: list[torch.Tensor]):
    """Pack (S+3, H_o, W_o) octaves into one (R, C) atlas + index tables; a
    leading (B,) axis on every octave gives one (B, R, C) atlas, written in
    place.

    Scale s of octave o occupies rows [row_off[o] + s*hprime[o],
    row_off[o] + (s+1)*hprime[o]); the image starts ROW_PAD rows and
    COL_PAD columns into its band; everything else is zero.
    """
    device = gauss_octaves[0].device
    lead = tuple(gauss_octaves[0].shape[:-3])
    lay = _atlas_static(tuple(tuple(g.shape[-3:]) for g in gauss_octaves), device)
    n_cols = lay["n_cols"]
    atlas = torch.zeros((*lead, lay["n_rows"], n_cols), dtype=ATLAS_DTYPE, device=device)
    for g, r, hp in zip(gauss_octaves, lay["rows"], lay["hp"]):
        s, h, w = g.shape[-3:]
        band = atlas[..., r:r + s * hp, :].view(*lead, s, hp, n_cols)
        band[..., ROW_PAD:ROW_PAD + h, COL_PAD:COL_PAD + w] = g
    return atlas, {k: lay[k] for k in ("row_off", "hprime", "wlim")}


def _patch_origins(meta: dict, n_oct: int, kp: Keypoints, max_radius: int, rows: int):
    """Patch origins in the atlas, aligned down to ROW_ALIGN rows and 128
    columns, for (rows, 256) patches covering ``max_radius`` around each
    keypoint. Returns (grow, x0, py, px, sig_o): int32 origins, the in-patch
    keypoint coordinates and the keypoint sigma in octave pixels."""
    o = kp.octave.clamp(0, n_oct - 1).long()
    inv = torch.exp2(-o.to(torch.float32))
    y_o, x_o, sig_o = kp.y * inv, kp.x * inv, kp.sigma * inv
    ya = y_o + ROW_PAD
    xa = x_o + COL_PAD
    hp = meta["hprime"][o]
    wl = meta["wlim"][o]
    ro = meta["row_off"][o]
    zero = torch.zeros_like(hp)
    y0l = torch.clamp(
        (torch.floor((ya - max_radius) / ROW_ALIGN) * ROW_ALIGN).to(torch.int32),
        zero, hp - rows,
    )
    x0 = torch.clamp(
        (torch.floor((xa - (max_radius + 1.0)) / 128.0) * 128).to(torch.int32),
        zero, wl,
    )
    grow = (ro + kp.scale * hp + y0l).to(torch.int32).contiguous()
    py = ya - y0l.to(torch.float32)
    px = xa - x0.to(torch.float32)
    return grow, x0.contiguous(), py, px, sig_o


def _keypoint_patches(
    gauss_octaves: list[torch.Tensor], kp: Keypoints, max_radius: int = MAX_RADIUS
):
    """One aligned (patch_rows_for(max_radius), 256) patch per keypoint from
    its own plane. Returns (patches, py, px, sig_o); with a leading (B,) axis
    on octaves and keypoints, all B * K patches come from one batched gather
    and every output keeps the (B, K) axes."""
    rows = patch_rows_for(max_radius)
    atlas, meta = build_atlas(gauss_octaves)
    grow, x0, py, px, sig_o = _patch_origins(meta, len(gauss_octaves), kp, max_radius, rows)
    gather = extract_atlas_patches_batched if atlas.dim() == 3 else extract_atlas_patches
    return gather(atlas, grow, x0, rows, PATCH_COLS), py, px, sig_o


def _radii(sig_o: torch.Tensor, max_radius: int = MAX_RADIUS):
    """Per-keypoint (orientation, descriptor) grid radii, clamped to the
    guaranteed patch coverage."""
    rad_o = torch.clamp(ORI_RADIUS_FACTOR * ORI_SIGMA_FACTOR * sig_o, max=max_radius - 1.0)
    rad_d = torch.clamp(
        DESC_BIN_SIGMA * sig_o * (2**0.5) * (DESC_WIDTH + 1) * 0.5, max=max_radius - 1.0
    )
    return rad_o, rad_d


# Sample both grids with the fused gather-resample kernel instead of the
# patch gather + two batched products. Off by default, as in the JAX package.
USE_FUSED_SAMPLING = False


def _fused_sample_grids(gauss_octaves: list[torch.Tensor], kp: Keypoints):
    """The JAX package's fused branch: MAX_RADIUS-wide (PATCH_ROWS, 256)
    patches, both grids sampled by ``ops/gather_resample``. Returns
    (samples_o, samples_d, rad_o, rad_d, sig_o)."""
    atlas, meta = build_atlas(gauss_octaves)
    grow, x0, py, px, sig_o = _patch_origins(
        meta, len(gauss_octaves), kp, MAX_RADIUS, PATCH_ROWS
    )
    rad_o, rad_d = _radii(sig_o)
    params = torch.stack([py, px, rad_o, rad_d], dim=1).contiguous()
    samples_o, samples_d = gather_resample(atlas, grow, x0, params)
    return samples_o, samples_d, rad_o, rad_d, sig_o


def _sample_grids(
    gauss_octaves: list[torch.Tensor], kp: Keypoints, max_radius: int = MAX_RADIUS
):
    """One patch read per keypoint -> both sample grids. Returns
    (samples_o (K,18,18), samples_d (K,26,26), off_o, off_d, sig_o); a batch
    comes back folded, K standing for B * K."""
    device = kp.x.device
    lin_o = torch.linspace(-1.0, 1.0, ORI_GRID, device=device)
    lin_d = torch.linspace(-1.0, 1.0, DESC_GRID, device=device)
    if USE_FUSED_SAMPLING and kp.x.dim() == 2:
        # The fused kernel takes one atlas: frame by frame.
        per_frame = [
            _fused_sample_grids([g[i] for g in gauss_octaves], Keypoints(*[f[i] for f in kp]))
            for i in range(kp.x.shape[0])
        ]
        samples_o, samples_d, rad_o, rad_d, sig_o = (torch.cat(t) for t in zip(*per_frame))
    elif USE_FUSED_SAMPLING:
        samples_o, samples_d, rad_o, rad_d, sig_o = _fused_sample_grids(gauss_octaves, kp)
    else:
        patches, py, px, sig_o = _keypoint_patches(gauss_octaves, kp, max_radius=max_radius)
        patches = patches.view(-1, *patches.shape[-2:])
        py, px, sig_o = py.reshape(-1), px.reshape(-1), sig_o.reshape(-1)
        rad_o, rad_d = _radii(sig_o, max_radius=max_radius)
        samples_o = resample(patches, py, px, lin_o[None] * rad_o[:, None])
        samples_d = resample(patches, py, px, lin_d[None] * rad_d[:, None])
    off_o = lin_o[None] * rad_o[:, None]
    off_d = lin_d[None] * rad_d[:, None]
    return samples_o, samples_d, off_o, off_d, sig_o


def _smooth_hist_circular(hist: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """[1,4,6,4,1]/16 circular smoothing along the last axis."""
    for _ in range(iters):
        hist = (
            6 * hist
            + 4 * (torch.roll(hist, 1, -1) + torch.roll(hist, -1, -1))
            + (torch.roll(hist, 2, -1) + torch.roll(hist, -2, -1))
        ) / 16.0
    return hist


def _take(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(h, -1, idx[:, None])[:, 0]


def _orientation_from_samples(samples, offsets, sig_o, kp: Keypoints):
    """Dominant and secondary orientation from the (K, 18, 18) grid.
    Returns (theta1, theta2, second_ok)."""
    k = kp.capacity
    win_sigma = ORI_SIGMA_FACTOR * sig_o
    gy, gx = grid_gradients(samples)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(k, -1)
    ang = torch.atan2(gy, gx).reshape(k, -1)

    du = offsets[:, 1:-1]
    d2 = du[:, :, None] ** 2 + du[:, None, :] ** 2
    w = mag * torch.exp(-d2.reshape(k, -1) / (2.0 * win_sigma[:, None] ** 2 + 1e-12))

    # Linear (hat-weighted, circular) binning.
    binf = (ang + math.pi) / (2 * math.pi) * N_ORI_BINS
    bins = torch.arange(N_ORI_BINS, dtype=torch.float32, device=samples.device)
    db = (binf[..., None] - bins).abs()
    db = torch.minimum(db, N_ORI_BINS - db)
    wb = torch.clamp(1.0 - db, min=0.0)
    hist = torch.bmm(w[:, None, :], wb)[:, 0]
    hist = _smooth_hist_circular(hist)

    def peak_theta(h, peak):
        hp = _take(h, peak)
        hl = _take(h, (peak - 1) % N_ORI_BINS)
        hr = _take(h, (peak + 1) % N_ORI_BINS)
        denom = hl - 2 * hp + hr
        frac = torch.where(denom.abs() > 1e-12, 0.5 * (hl - hr) / denom,
                           torch.zeros_like(denom))
        binf = peak.to(torch.float32) + frac
        theta = binf / N_ORI_BINS * 2 * math.pi - math.pi
        return torch.remainder(theta + math.pi, 2 * math.pi) - math.pi, hp

    peak1 = torch.argmax(hist, dim=-1)
    theta1, h1 = peak_theta(hist, peak1)
    # Lowe's 80% rule: best bin at circular distance >= 2 from the primary,
    # within 80% of it and a local maximum.
    ibins = torch.arange(N_ORI_BINS, device=samples.device)
    d = (ibins[None, :] - peak1[:, None]).abs()
    d = torch.minimum(d, N_ORI_BINS - d)
    masked = torch.where(d >= 2, hist, torch.full_like(hist, -torch.inf))
    peak2 = torch.argmax(masked, dim=-1)
    theta2, h2 = peak_theta(hist, peak2)
    hl2 = _take(hist, (peak2 - 1) % N_ORI_BINS)
    hr2 = _take(hist, (peak2 + 1) % N_ORI_BINS)
    second_ok = (h2 >= 0.8 * h1) & (h2 >= hl2) & (h2 >= hr2)
    return theta1, theta2, second_ok


def orient_and_describe(
    gauss_octaves: list[torch.Tensor],
    kp: Keypoints,
    dual_orientation: bool = False,
    max_radius: int = MAX_RADIUS,
) -> tuple[Keypoints, torch.Tensor]:
    """One patch gather feeds orientation AND descriptor.

    With ``dual_orientation`` (Lowe's 80% rule) the capacity doubles: slots
    [K:2K) repeat each keypoint with the secondary peak's orientation,
    valid only where a qualifying second peak exists. (B, S+3, H_o, W_o)
    octaves with (B, K) keypoints give (B, K or 2K) keypoints and (B, K or
    2K, 128) descriptors.

    Every device operation runs in one of the sub-spans
    ``sift.describe.sample`` (atlas, patches, resample),
    ``sift.describe.orient`` and ``sift.describe.histogram`` (both
    orientations' descriptors and normalisation in one ``ops/descriptor_hist``
    call, written in place; the assembly of the keypoints).
    """
    lead = tuple(kp.x.shape[:-1])
    with span("sift.describe.sample"):
        s_o, s_d, off_o, off_d, sig_o = _sample_grids(gauss_octaves, kp, max_radius=max_radius)
    with span("sift.describe.orient"):
        kp = Keypoints(*[f.reshape(-1) for f in kp])       # fold frames into keypoints
        theta1, theta2, second_ok = _orientation_from_samples(s_o, off_o, sig_o, kp)
        zero = torch.zeros_like(theta1)
        kp1 = kp._replace(orientation=torch.where(kp.valid, theta1, zero))
    with span("sift.describe.histogram"):
        unfold = lambda t: t.reshape(*lead, -1, *t.shape[1:])
        grids = (unfold(s_d), unfold(off_d), unfold(sig_o))
        first = (unfold(kp1.orientation), unfold(kp1.valid))
        if not dual_orientation:
            return Keypoints(*map(unfold, kp1)), descriptor_hist(*grids, (first,))
        valid2 = kp.valid & second_ok
        kp2 = kp._replace(orientation=torch.where(valid2, theta2, zero), valid=valid2)
        desc = descriptor_hist(*grids, (first, (unfold(kp2.orientation), unfold(valid2))))
        both = Keypoints(*[torch.cat([unfold(a), unfold(b)], dim=-1) for a, b in zip(kp1, kp2)])
        return both, desc


def assign_orientations(gauss_octaves: list[torch.Tensor], kp: Keypoints) -> Keypoints:
    """Fill ``kp.orientation`` with the dominant gradient direction (0 at
    invalid slots): one orientation a keypoint; :func:`orient_and_describe`
    with ``dual_orientation`` gives Lowe's secondary-peak duplicates."""
    s_o, _s_d, off_o, _off_d, sig_o = _sample_grids(gauss_octaves, kp)
    flat = Keypoints(*[f.reshape(-1) for f in kp])
    theta, _theta2, _ok = _orientation_from_samples(s_o, off_o, sig_o, flat)
    theta = torch.where(flat.valid, theta, torch.zeros_like(theta))
    return kp._replace(orientation=theta.reshape(kp.valid.shape))


def compute_descriptors(gauss_octaves: list[torch.Tensor], kp: Keypoints) -> torch.Tensor:
    """(K, 128) L2-normalised, 0.2-clipped SIFT descriptors (Lowe 2004) at
    the keypoints' own orientations; zero rows at invalid slots."""
    _s_o, s_d, _off_o, off_d, sig_o = _sample_grids(gauss_octaves, kp)
    slots = tuple(kp.valid.shape)
    unfold = lambda t: t.reshape(*slots, *t.shape[1:])
    orientation = (kp.orientation.contiguous(), kp.valid.contiguous())
    return descriptor_hist(unfold(s_d), unfold(off_d), unfold(sig_o), (orientation,))
