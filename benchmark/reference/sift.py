"""Plain SIFT features of one frame: the benchmark's reference.

The frontend's semantics written out directly, in float64, from the
configuration alone: no blur matrices, band blocks, atlases, score tables
or kernels, and nothing imported from the program. Each step is the
textbook operation the program's fast path stands for:

* pyramid: separable Gaussian blurs with replicated edges (taps of radius
  ceil(3 sigma), normalised), each scale blurred from its octave's base,
  the next base the scale-S plane at every second row and column;
* DoG: differences of adjacent scales;
* detection: every voxel's 26-neighbour extremum test, quadratic fit
  (3x3 solve by the adjugate), edge test and contrast; the ranking key is
  the contrast's float32 bits with the first refinement hop in the 5 low
  bits; each octave offers the top two keys of every 64-voxel run of its
  flat score volume (every voxel where it has fewer than 4096), and one
  stable top-K over all octaves picks the keypoints, each re-fitted one
  hop away;
* orientation: a 36-bin histogram of the gradients on an 18 x 18 grid,
  smoothed twice, the parabolic peak, and Lowe's 80% secondary peak;
* descriptor: the gradients of a 26 x 26 grid, rotated to the keypoint's
  orientation, voted trilinearly into 4 x 4 x 8 bins, normalised, clipped
  at 0.2 and normalised again. Grid samples are bilinear, zero outside the
  image.

``tf32=True`` computes every blur product from operands rounded to TF32
(10 mantissa bits, as the tensor cores read float32 with TF32 on): the
control, one precision below the configuration's.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64

N_ORI_BINS = 36
ORI_GRID = 18
DESC_GRID = 26
DESC_WIDTH = 4
DESC_ORI_BINS = 8
DESC_CLIP = 0.2
MAX_OFFSET = 0.6
SPAN = 64
DENSE_BELOW = 4096
MAX_RADIUS = 52


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (float32 with 10 explicit mantissa bits, ties
    away from zero), in ``x``'s dtype."""
    bits = x.to(torch.float32).view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def gaussian_taps(sigma: float, device) -> torch.Tensor:
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-r, r + 1, dtype=F64, device=device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _blur_axis(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    n, r = x.shape[dim], taps.shape[0] // 2
    out = torch.zeros_like(x)
    for t in range(taps.shape[0]):
        idx = (torch.arange(n, device=x.device) + t - r).clamp(0, n - 1)
        out += taps[t] * x.index_select(dim, idx)
    return out


def blur(x: torch.Tensor, sigma: float, tf32: bool = False) -> torch.Tensor:
    """Separable Gaussian blur of (H, W) with replicated edges: along the
    rows, then along the columns."""
    taps = gaussian_taps(sigma, x.device)
    if tf32:
        taps, x = tf32_round(taps), tf32_round(x)
    x = _blur_axis(x, taps, 1)
    if tf32:
        x = tf32_round(x)
    return _blur_axis(x, taps, 0)


def n_octaves(cfg: dict) -> int:
    """floor(log2(side)) + 1 octaves, cut to those whose side keeps at least
    ``min_octave_size`` pixels (the short side sets the count)."""
    side = min(cfg["height"], cfg["width"])
    usable = max(1, int(math.log2(max(side // cfg["min_octave_size"], 1))) + 1)
    return min(side.bit_length(), usable)


def gaussian_pyramid(img: torch.Tensor, cfg: dict, tf32: bool = False) -> list[torch.Tensor]:
    """(H, W) frame -> (S+3, H_o, W_o) Gaussian octaves."""
    S, s0 = cfg["S"], cfg["sigma0"]
    x = blur(img.to(F64), math.sqrt(max(s0 ** 2 - cfg["assumed_blur"] ** 2, 1e-12)), tf32)
    sig = [s0 * 2.0 ** (s / S) for s in range(S + 3)]
    rel = [math.sqrt(max(sig[s] ** 2 - s0 ** 2, 1e-12)) for s in range(1, S + 3)]
    octaves = []
    for _ in range(n_octaves(cfg)):
        g = torch.stack([x] + [blur(x, r, tf32) for r in rel])
        octaves.append(g)
        x = g[S, ::2, ::2]
    return octaves


def _fit_fields(dog: torch.Tensor, thr: float, edge_ratio: float) -> dict:
    """Every interior voxel of an (S+2, H, W) DoG: the extremum test, the
    quadratic fit's offsets (s, y, x), its contrast and the edge test, each
    (S, H-2, W-2)."""
    c = dog[1:-1, 1:-1, 1:-1]
    D, H, W = dog.shape
    at = lambda ds, dy, dx: dog[1 + ds:D - 1 + ds, 1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx]
    mx, mn = c.clone(), c.clone()
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                v = at(ds, dy, dx)
                mx, mn = torch.maximum(mx, v), torch.minimum(mn, v)
    extremum = (c >= mx) | (c <= mn)
    gs, gy, gx = ((at(1, 0, 0) - at(-1, 0, 0)) / 2, (at(0, 1, 0) - at(0, -1, 0)) / 2,
                  (at(0, 0, 1) - at(0, 0, -1)) / 2)
    hss = at(1, 0, 0) + at(-1, 0, 0) - 2 * c
    hyy = at(0, 1, 0) + at(0, -1, 0) - 2 * c
    hxx = at(0, 0, 1) + at(0, 0, -1) - 2 * c
    hsy = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) / 4
    hsx = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) / 4
    hyx = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) / 4
    # H off = -g by the adjugate of H = [[hss, hsy, hsx], [hsy, hyy, hyx], [hsx, hyx, hxx]].
    A = hyy * hxx - hyx * hyx
    B = hsx * hyx - hsy * hxx
    C = hsy * hyx - hsx * hyy
    Dd = hss * hxx - hsx * hsx
    E = hsy * hsx - hss * hyx
    Fd = hss * hyy - hsy * hsy
    det = hss * A + hsy * B + hsx * C
    inv = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    off = torch.stack([-(A * gs + B * gy + C * gx) * inv,
                       -(B * gs + Dd * gy + E * gx) * inv,
                       -(C * gs + E * gy + Fd * gx) * inv])
    g = torch.stack([gs, gy, gx])
    tr, det2 = hxx + hyy, hxx * hyy - hyx * hyx
    edge_ok = (det2 > 0) & (tr * tr * edge_ratio < (edge_ratio + 1) ** 2 * det2)
    d_rank = c + 0.5 * (g * off.clamp(-MAX_OFFSET, MAX_OFFSET)).sum(0)
    d_hat = c + 0.5 * (g * off).sum(0)
    score = torch.where(extremum & (d_rank.abs() > thr) & edge_ok, d_rank.abs(), 0.0)
    step = torch.round(off).clamp(-1, 1).to(torch.int64) + 1
    conv = (off.abs() <= MAX_OFFSET).all(0)
    hop = torch.where(conv, 13, step[0] * 9 + step[1] * 3 + step[2])
    bits = score.to(torch.float32).view(torch.int32).to(torch.int64)
    key = torch.where(score > 0, (bits & ~31) | hop, 0)
    return {"score": score, "key": key, "off": off, "d_hat": d_hat, "edge_ok": edge_ok}


def _octave_entries(f: dict, k: int):
    """An octave's candidate (keys, flat indices): every voxel by score
    (fewer than 4096 voxels: the top min(k, V)), else each 64-voxel run's
    top two keys, all firsts then all seconds."""
    key, score = f["key"].reshape(-1), f["score"].reshape(-1)
    vg = key.shape[0]
    if vg < DENSE_BELOW:
        order = torch.sort(score, descending=True, stable=True).indices[:min(k, vg)]
        return key[order], order
    nblk = -(-vg // SPAN)
    rows = torch.cat([key, key.new_zeros(nblk * SPAN - vg)]).view(nblk, SPAN)
    m1, a1 = rows.max(dim=1)
    m2, a2 = rows.scatter(1, a1[:, None], -1).max(dim=1)
    base = SPAN * torch.arange(nblk, device=key.device)
    idx = torch.cat([base + a1, base + a2]).clamp(max=vg - 1)
    return torch.cat([m1, m2]), idx


def detect(dogs: list[torch.Tensor], cfg: dict) -> dict:
    """``max_keypoints`` keypoint slots of one frame's DoG octaves."""
    S, cap = cfg["S"], cfg["max_keypoints"]
    thr = cfg["contrast_threshold"] / S
    fields = [_fit_fields(d, thr, cfg["edge_ratio"]) for d in dogs]
    n_total = sum(f["key"].numel() for f in fields)
    k = min(cap, n_total)
    keys, idx, octs, base = [], [], [], 0
    for o, f in enumerate(fields):
        kk, ii = _octave_entries(f, k)
        keys.append(kk)
        idx.append(ii)
        octs.append(torch.full_like(ii, o))
    keys, idx, octs = torch.cat(keys), torch.cat(idx), torch.cat(octs)
    if keys.shape[0] < k:
        pad = k - keys.shape[0]
        keys, idx, octs = (torch.cat([t, t.new_zeros(pad)]) for t in (keys, idx, octs))
    sel = torch.sort(keys, descending=True, stable=True).indices[:k]
    keys, idx, octs = keys[sel], idx[sel], octs[sel]
    dev = keys.device
    out = {n: torch.zeros(cap, dtype=F64, device=dev) for n in ("x", "y", "sigma", "score")}
    out["octave"] = torch.zeros(cap, dtype=torch.int64, device=dev)
    out["scale"] = torch.zeros(cap, dtype=torch.int64, device=dev)
    out["valid"] = torch.zeros(cap, dtype=torch.bool, device=dev)
    for o, f in enumerate(fields):
        slot = torch.nonzero(octs == o).flatten()
        _s, hs, ws = f["key"].shape
        rem, key = idx[slot], keys[slot]
        hop = key & 31
        val = ((key & ~31).to(torch.int32)).view(torch.float32)
        s = ((rem // (hs * ws)) + hop // 9 - 1).clamp(0, S - 1)
        y = ((rem // ws) % hs + (hop // 3) % 3 - 1).clamp(0, hs - 1)
        x = (rem % ws + hop % 3 - 1).clamp(0, ws - 1)
        off = f["off"][:, s, y, x]
        d_hat = f["d_hat"][s, y, x]
        valid = ((val > 0) & (off.abs() < MAX_OFFSET).all(0) & f["edge_ok"][s, y, x]
                 & (d_hat.abs() > thr))
        mult = 2.0 ** o
        out["x"][slot] = torch.where(valid, (x + 1 + off[2]) * mult, 0.0)
        out["y"][slot] = torch.where(valid, (y + 1 + off[1]) * mult, 0.0)
        out["sigma"][slot] = torch.where(
            valid, cfg["sigma0"] * 2.0 ** ((s + 1 + off[0]) / S) * mult, 0.0)
        out["score"][slot] = torch.where(valid, d_hat.abs(), 0.0)
        out["octave"][slot] = o
        out["scale"][slot] = s + 1
        out["valid"][slot] = valid
    return out


def max_patch_radius(cfg: dict) -> int:
    """The largest sample radius the frontend guarantees: that of the
    largest refined scale, sigma0 * 2^((S + 0.6) / S)."""
    S = cfg["S"]
    sig_max = cfg["sigma0"] * 2.0 ** ((S + MAX_OFFSET) / S)
    rad_d = 3.0 * sig_max * math.sqrt(2.0) * (DESC_WIDTH + 1) / 2
    rad_o = 3.0 * 1.5 * sig_max
    return min(MAX_RADIUS, int(math.ceil(max(rad_d, rad_o))) + 1)


def _sample(octave: torch.Tensor, plane: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of planes ``plane`` (N,) of an (P, H, W) octave at
    (N, G) rows ``ys`` x (N, G) columns ``xs``: (N, G, G), zero outside
    the image."""
    _p, h, w = octave.shape
    flat = octave.reshape(-1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    base = (plane * h * w)[:, None, None]
    out = torch.zeros((ys.shape[0], ys.shape[1], xs.shape[1]), dtype=octave.dtype,
                      device=octave.device)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            ok = ((yy >= 0) & (yy < h))[:, :, None] & ((xx >= 0) & (xx < w))[:, None, :]
            pos = base + yy.clamp(0, h - 1)[:, :, None] * w + xx.clamp(0, w - 1)[:, None, :]
            out += torch.where(ok, flat[pos], 0.0) * wy[:, :, None] * wx[:, None, :]
    return out


def _gradients(s: torch.Tensor):
    return (s[:, 2:, 1:-1] - s[:, :-2, 1:-1]) / 2, (s[:, 1:-1, 2:] - s[:, 1:-1, :-2]) / 2


def _hat(pos: torch.Tensor, n: int, circular: bool) -> torch.Tensor:
    """(..., n) hat weights max(0, 1 - |pos - b|) of bins b = 0..n-1."""
    d = (pos[..., None] - torch.arange(n, dtype=pos.dtype, device=pos.device)).abs()
    if circular:
        d = torch.minimum(d, n - d)
    return (1.0 - d).clamp(min=0.0)


def orientations(s_o: torch.Tensor, off: torch.Tensor, sig_o: torch.Tensor):
    """(theta1, theta2, second_ok) from (N, 18, 18) samples at offsets (N, 18)."""
    n = s_o.shape[0]
    gy, gx = _gradients(s_o)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(n, -1)
    ang = torch.atan2(gy, gx).reshape(n, -1)
    du = off[:, 1:-1]
    d2 = (du[:, :, None] ** 2 + du[:, None, :] ** 2).reshape(n, -1)
    wsig = 1.5 * sig_o
    w = mag * torch.exp(-d2 / (2.0 * wsig[:, None] ** 2 + 1e-12))
    hist = (w[..., None] * _hat((ang + math.pi) / (2 * math.pi) * N_ORI_BINS, N_ORI_BINS,
                                True)).sum(1)
    for _ in range(2):
        r = lambda k: torch.roll(hist, k, -1)
        hist = (6 * hist + 4 * (r(1) + r(-1)) + (r(2) + r(-2))) / 16.0
    take = lambda p: torch.gather(hist, 1, (p % N_ORI_BINS)[:, None])[:, 0]

    def peak_theta(p):
        hp, hl, hr = take(p), take(p - 1), take(p + 1)
        den = hl - 2 * hp + hr
        frac = torch.where(den.abs() > 1e-12, 0.5 * (hl - hr) / den, 0.0)
        theta = (p + frac) / N_ORI_BINS * 2 * math.pi - math.pi
        return torch.remainder(theta + math.pi, 2 * math.pi) - math.pi, hp, hl, hr

    p1 = torch.argmax(hist, dim=-1)
    theta1, h1, _, _ = peak_theta(p1)
    b = torch.arange(N_ORI_BINS, device=hist.device)
    d = (b[None, :] - p1[:, None]).abs()
    d = torch.minimum(d, N_ORI_BINS - d)
    p2 = torch.argmax(torch.where(d >= 2, hist, -torch.inf), dim=-1)
    theta2, h2, hl2, hr2 = peak_theta(p2)
    return theta1, theta2, (h2 >= 0.8 * h1) & (h2 >= hl2) & (h2 >= hr2)


def descriptors(s_d: torch.Tensor, off: torch.Tensor, sig_o: torch.Tensor,
                theta: torch.Tensor) -> torch.Tensor:
    """(N, 128) normalised descriptors from (N, 26, 26) samples at offsets
    (N, 26), at orientations ``theta``."""
    n, d = s_d.shape[0], DESC_WIDTH
    gy, gx = _gradients(s_d)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(n, -1)
    ang = torch.atan2(gy, gx).reshape(n, -1) - theta[:, None]
    du = off[:, 1:-1]
    g = du.shape[1]
    dy = du[:, :, None].expand(n, g, g).reshape(n, -1)
    dx = du[:, None, :].expand(n, g, g).reshape(n, -1)
    bw = (3.0 * sig_o).clamp(min=1e-6)[:, None]
    cos_t, sin_t = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    u = (cos_t * dy - sin_t * dx) / bw
    v = (sin_t * dy + cos_t * dx) / bw
    w = mag * torch.exp(-(u * u + v * v) / (0.5 * d * d))
    wr = _hat(u + d / 2.0 - 0.5, d, False)
    wc = _hat(v + d / 2.0 - 0.5, d, False)
    wo = _hat(torch.remainder(ang, 2 * math.pi) / (2 * math.pi) * DESC_ORI_BINS,
              DESC_ORI_BINS, True)
    hist = torch.einsum("np,npr,npc,npo->nrco", w, wr, wc, wo).reshape(n, -1)
    desc = hist / hist.norm(dim=-1, keepdim=True).clamp(min=1e-7)
    desc = desc.clamp(max=DESC_CLIP)
    return desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-7)


def describe(gauss: list[torch.Tensor], kp: dict, cfg: dict, chunk: int = 256) -> dict:
    """Orientation (with Lowe's secondary peak when the configuration asks
    for dual orientations: slots [K, 2K)) and descriptors of the valid
    keypoint slots. Returns the slots' fields and ``desc`` (slots, 128)."""
    cap = kp["x"].shape[0]
    dev = kp["x"].device
    max_r = max_patch_radius(cfg)
    lin_o = torch.linspace(-1.0, 1.0, ORI_GRID, dtype=F64, device=dev)
    lin_d = torch.linspace(-1.0, 1.0, DESC_GRID, dtype=F64, device=dev)
    theta1 = torch.zeros(cap, dtype=F64, device=dev)
    theta2 = torch.zeros(cap, dtype=F64, device=dev)
    ok2 = torch.zeros(cap, dtype=torch.bool, device=dev)
    desc1 = torch.zeros((cap, 128), dtype=F64, device=dev)
    desc2 = torch.zeros((cap, 128), dtype=F64, device=dev)
    for o, g in enumerate(gauss):
        slots = torch.nonzero(kp["valid"] & (kp["octave"] == o)).flatten()
        for c in range(0, slots.shape[0], chunk):
            sl = slots[c:c + chunk]
            inv = 2.0 ** -o
            y, x, sig = kp["y"][sl] * inv, kp["x"][sl] * inv, kp["sigma"][sl] * inv
            plane = kp["scale"][sl]
            rad_o = (4.5 * sig).clamp(max=max_r - 1.0)
            rad_d = (3.0 * sig * math.sqrt(2.0) * (DESC_WIDTH + 1) * 0.5).clamp(max=max_r - 1.0)
            off_o, off_d = lin_o * rad_o[:, None], lin_d * rad_d[:, None]
            s_o = _sample(g, plane, y[:, None] + off_o, x[:, None] + off_o)
            s_d = _sample(g, plane, y[:, None] + off_d, x[:, None] + off_d)
            t1, t2, second = orientations(s_o, off_o, sig)
            theta1[sl], theta2[sl], ok2[sl] = t1, t2, second
            desc1[sl] = descriptors(s_d, off_d, sig, t1)
            desc2[sl] = torch.where(second[:, None], descriptors(s_d, off_d, sig, t2), 0.0)
    first = dict(kp, orientation=torch.where(kp["valid"], theta1, 0.0), desc=desc1)
    if not cfg["dual_orientation"]:
        return first
    valid2 = kp["valid"] & ok2
    second = dict(kp, orientation=torch.where(valid2, theta2, 0.0), valid=valid2,
                  desc=torch.where(valid2[:, None], desc2, 0.0))
    return {n: torch.cat([first[n], second[n]]) for n in first}


def features(img: torch.Tensor, cfg: dict, tf32: bool = False) -> dict:
    """The reference's features of one (H, W) frame: keypoint slot fields
    (x, y, sigma, score, orientation, octave, scale, valid) and ``desc``."""
    gauss = gaussian_pyramid(img, cfg, tf32)
    kp = detect([g[1:] - g[:-1] for g in gauss], cfg)
    return describe(gauss, kp, cfg)
