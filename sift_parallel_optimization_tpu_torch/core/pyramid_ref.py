"""Scale-space pyramids in PyTorch (port of ``core/pyramid_ref.py``).

* REFERENCE mode: the reference study's program. Each octave is the
  2^o-strided subsample of the original image times a separable Gaussian
  window per scale, with adjacent-scale DoG (GuassDePyramid.h:60-149). On a
  CUDA tensor :func:`reference_dog_pyramid` is one launch of the fused kernel
  in ``ops/scale_space.py``; the functions here are its plain version.
* SIFT mode: a true Gaussian scale space. Blurs are edge-clamped Toeplitz
  products ``B_h^T X B_w`` (no cuDNN convolution, which defaults to TF32 on
  Hopper): dense products, or, for an octave whose long side is at least
  :data:`_BANDED_MIN_SIZE`, the blocked-band form (:func:`blur_bank_banded`:
  batched products over the band's 64-column blocks only). The octave
  cascade is the blur -> subsample loop down to the octaves of side at most
  :data:`_SIFT_TAIL_MAX`, which come from their first base in one pair of
  batched products with precomposed operators (:class:`TailBank`). Every
  blur product goes through :func:`blur_product`, in the arithmetic that
  ``PyramidConfig.blur_precision`` names: full fp32 ("highest") or the 3-pass
  bf16 product ("high", kernel 5 on the card). The matrices live on the
  device as buffers of :class:`SiftPyramid`: f32, or at "high" split once
  into bf16 pairs when the module is built (:class:`_BlurMatrices`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sift_parallel_optimization_tpu_torch.config import (
    REF_PI,
    REF_SIGMA,
    PyramidConfig,
    num_octaves,
)
from sift_parallel_optimization_tpu_torch.ops.blur_product import (
    SplitPair,
    bf16x3_bmm,
    split_pair,
)

# ---------------------------------------------------------------------------
# REFERENCE mode
# ---------------------------------------------------------------------------


def reference_filter_bank(
    size: int, n_scales: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(n_scales, size) bank of the reference's 1-D Gaussian windows:
    f_s[i] = exp(-(i-c)^2 / (2 sig_s^2)) / (sig_s sqrt(2 PI)), sig_s = 2/(s+1),
    c = (size-1)/2 (GuassDePyramid.h:117-120)."""
    f32 = torch.float32
    i = torch.arange(size, dtype=f32, device=device)
    s = torch.arange(n_scales, dtype=f32, device=device)
    sig = REF_SIGMA / (s + 1.0)
    x = i - (size - 1) / 2.0
    # sqrt in f32 of the f32-rounded constant, as the JAX expression does
    # (a fill, not a copy from the host, so a CUDA graph can capture it).
    root = torch.sqrt(torch.full((), 2.0 * REF_PI, dtype=f32, device=device))
    f = torch.exp(-(x[None, :] ** 2) / (2.0 * sig[:, None] ** 2)) / (
        sig[:, None] * root
    )
    return f.to(dtype)


def window_dog_planes(f: torch.Tensor) -> torch.Tensor:
    """(n_scales, N) window bank -> (n_scales, N, N) separable weights:
    planes 0..S+1 hold W_s - W_{s+1}, plane S+2 holds W_{S+2}."""
    windows = f[:, :, None] * f[:, None, :]
    return torch.cat([windows[:-1] - windows[1:], windows[-1:]], dim=0)


def reference_dog_octave(base: torch.Tensor, S: int) -> torch.Tensor:
    """(size, size) octave base -> (S+3, size, size): DoG planes + top scale."""
    f = reference_filter_bank(
        base.shape[-1], S + 3, dtype=base.dtype, device=base.device
    )
    return base[None, :, :] * window_dog_planes(f)


def strided_subsample(img: torch.Tensor, step: int) -> torch.Tensor:
    """``img[..., ::step, ::step]``: every ``step``-th row and column from the
    first, ceil(n / step) of each (the samples of the JAX package's 1x1-window,
    stride-``step`` VALID reduce_window). A view."""
    return img[..., ::step, ::step]


def reference_subsample(img: torch.Tensor, octave: int) -> torch.Tensor:
    """Octave base: the 2^o-strided subsample of the ORIGINAL image."""
    step = 2**octave
    size = img.shape[0] // step
    return strided_subsample(img, step)[:size, :size]


def reference_dog_pyramid(
    img: torch.Tensor, S: int, n_octaves: int | None = None
) -> list[torch.Tensor]:
    """REFERENCE pyramid: list of (S+3, size_o, size_o) per octave.

    A CUDA tensor goes through the fused CUDA kernel, a CPU tensor through
    the plain version (ops/scale_space.py holds both).
    """
    from sift_parallel_optimization_tpu_torch.ops import scale_space

    return scale_space.reference_dog_pyramid(
        img.to(torch.float32).contiguous(), S, n_octaves
    )


def clamp_octaves(length: int, n_octaves: int | None) -> int:
    total = num_octaves(length)
    return total if n_octaves is None else min(n_octaves, total)


# ---------------------------------------------------------------------------
# SIFT mode
# ---------------------------------------------------------------------------


def gaussian_kernel_1d(sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized 1-D Gaussian taps, radius = ceil(3 sigma)."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).to(dtype)


def separable_taps(ext: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(..., h + 2r, W) rows carrying r rows of context above and below ->
    (..., h, W): each row blurred along W with edge-clamped columns, then the
    taps along H over the context; each pass a sum of shifted slices in the
    rows' dtype (no convolution library call: cuDNN runs convolutions in
    TF32 on the card). The arithmetic of :func:`separable_blur` and of the
    row-sharded blur, which differ only in where the context rows come from."""
    k = taps.shape[0]
    r = k // 2
    taps = taps.to(ext.dtype)
    w = ext.shape[-1]
    edge = (*ext.shape[:-1], r)
    xw = torch.cat([ext[..., :1].expand(edge), ext, ext[..., -1:].expand(edge)], dim=-1)
    x = sum(taps[t] * xw[..., t:t + w] for t in range(k))
    h = ext.shape[-2] - 2 * r
    return sum(taps[t] * x[..., t:t + h, :] for t in range(k))


def separable_blur(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) with replicated edges: rows,
    then columns, with the (2r+1,) ``taps``."""
    r = taps.shape[0] // 2
    edge = (*x.shape[:-2], r, x.shape[-1])
    ext = torch.cat([x[..., :1, :].expand(edge), x, x[..., -1:, :].expand(edge)], dim=-2)
    return separable_taps(ext, taps)


def _octave_scale_sigmas(cfg: PyramidConfig) -> list[float]:
    """Composed sigmas: the blur applied to the octave BASE to reach scale s
    (Gaussian semigroup: sqrt(sig_s^2 - sigma0^2))."""
    sig = cfg.sift_sigmas()
    return [
        math.sqrt(max(sig[s] ** 2 - sig[0] ** 2, 1e-12))
        for s in range(1, cfg.n_scales)
    ]


def _taps_np(sigma: float) -> tuple[int, np.ndarray]:
    """(radius, f32 normalized Gaussian taps), summed in f64 then rounded:
    the taps of every blur matrix."""
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return r, (taps / taps.sum()).astype(np.float32)


def _blur_matrix_np(size: int, sigma: float) -> np.ndarray:
    """(size, size) f32 Toeplitz matrix with edge-clamped Gaussian taps."""
    r, taps = _taps_np(sigma)
    b = np.zeros((size, size), np.float32)
    v = np.arange(size)
    for k, t in enumerate(taps):
        u = np.clip(v + k - r, 0, size - 1)
        np.add.at(b, (u, v), t)
    return b


def blur_matrix(size: int, sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """B with (x @ B) == 1-D convolution of each row of x with
    gaussian_kernel_1d(sigma) after edge padding."""
    return torch.from_numpy(_blur_matrix_np(size, sigma)).to(device=device, dtype=dtype)


def _blur_stack(size: int, sigmas, dtype, device) -> torch.Tensor:
    return torch.stack([blur_matrix(size, s, dtype, device) for s in sigmas])


def blur_product(a, b, precision: str = "highest",
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``a @ b``, broadcast over batch dimensions, for every blur of the SIFT
    pyramid: "highest" is ``torch.bmm`` (into ``out``) on two 3-D operands
    and ``torch.matmul`` otherwise, in full fp32; "high" the 3-pass bf16
    product (``ops/blur_product.bf16x3_bmm``: kernel 5 on a CUDA tensor, its
    plain version on the CPU), every operand read in place, a constant one
    as the :class:`SplitPair` its module holds."""
    if precision == "high":
        return bf16x3_bmm(a, b, out=out)
    if precision != "highest":
        raise ValueError(f"unknown blur precision {precision!r}")
    if a.dim() == b.dim() == 3:
        return torch.bmm(a, b, out=out)
    return torch.matmul(a, b, out=out)


def blur_bank(x: torch.Tensor, bank_h: torch.Tensor, bank_w: torch.Tensor,
              precision: str = "highest") -> torch.Tensor:
    """(H, W) image -> (S', H, W): out_s = B^H_s^T @ x @ B^W_s. (B, H, W)
    frames -> (B, S', H, W): the same products broadcast over the frames."""
    return _blur_dense(x, bank_h.transpose(-1, -2), bank_w, precision)


def _blur_dense(x: torch.Tensor, bank_ht, bank_w, precision: str) -> torch.Tensor:
    """:func:`blur_bank` with the row bank given transposed, ``bank_ht`` =
    B^H^T (a transposed view, or the split pair stored so)."""
    if x.dim() == 3:
        x = x[:, None]
    return blur_product(bank_ht, blur_product(x, bank_w, precision), precision)


def check_fp32_matmul(x: torch.Tensor) -> None:
    """Refuse TF32 matmuls on the card: ~1e-3 blur error makes spurious DoG
    extrema (the failure the JAX package records for TPU bf16), and the
    matcher's similarities and every geometry product need their fp32 digits
    as much."""
    if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "fp32 matmul precision must be 'highest' (TF32 disabled) for the "
            "SIFT pyramid, the matcher and the geometry"
        )


# ---------------------------------------------------------------------------
# The blocked-band blur (the JAX package's blur_bank_banded)
# ---------------------------------------------------------------------------

# The band's column-block width, as in the JAX package.
BAND_WIDTH = 64
# An octave (and the base blur) whose long side is at least this many pixels
# blurs in the blocked-band form, a smaller one in the dense form. The rule
# reads the shape only, so the card and the CPU take the same form. On the
# H100 the banded form wins every call from 256^2 up (tools/banded_cutoff.py;
# PERF.md §6, PR 11), but below 512 the JAX package blurs densely, and a
# 256^2 octave in the other form moves keypoints 1.1e-4 px off the
# reference's: the cutoff stays the JAX package's.
_BANDED_MIN_SIZE = 512


def _blocks_of(mats, bw: int, r: int, nb: int) -> np.ndarray:
    """(len(mats), nb, bw + 2r, bw) column blocks of (size, size) matrices:
    block jb holds rows [jb*bw - r, jb*bw + bw + r) of columns [jb*bw,
    (jb+1)*bw), zero outside the matrix (``nb`` may pass the last column)."""
    size = mats[0].shape[0]
    pad = nb * bw - size
    out = np.zeros((len(mats), nb, bw + 2 * r, bw), np.float32)
    for i, m in enumerate(mats):
        bp = np.pad(m, ((r, r + pad), (0, pad)))
        for jb in range(nb):
            out[i, jb] = bp[jb * bw:jb * bw + bw + 2 * r, jb * bw:(jb + 1) * bw]
    return out


def _band_blocks_np(size: int, sigmas, bw: int, r: int) -> np.ndarray:
    """(S, ceil(size / bw), bw + 2r, bw) band blocks of the blur matrices:
    block jb holds B[jb*bw - r : jb*bw + bw + r, jb*bw : (jb+1)*bw], zero
    padded, every nonzero of column block jb when B's band half-width is at
    most r (the JAX package's layout, entry for entry)."""
    return _blocks_of([_blur_matrix_np(size, s) for s in sigmas], bw, r, -(-size // bw))


def _band_operands(h: int, w: int, sigmas, bw: int = BAND_WIDTH, with_input: bool = False):
    """The two operands of :func:`_blur_banded` for (h, w) images, with one
    radius r (the largest of ``sigmas``) and the block width widened to 2r
    where the band is wider than ``bw``. ``with_input`` makes the identity
    the first plane (the input itself, exactly: one product by 1.0, the rest
    by 0.0). Returns (rows (nbh, bw * n, bw + 2r): block ib's n planes
    transposed, row v * n + p; cols (n * nbw, bw + 2r, bw): plane p's column
    block jb at p * nbw + jb; r; bw), with one zero block past each axis'
    last (nbh = ceil(h / bw) + 1, nbw = ceil(w / bw) + 1)."""
    r = max(_taps_np(s)[0] for s in sigmas)
    bw = max(bw, 2 * r)
    k = bw + 2 * r

    def mats(size):
        eye = [np.eye(size, dtype=np.float32)] if with_input else []
        return eye + [_blur_matrix_np(size, s) for s in sigmas]

    blk_h = _blocks_of(mats(h), bw, r, -(-h // bw) + 1)             # (n, nbh, k, bw)
    n, nbh = blk_h.shape[:2]
    rows = np.ascontiguousarray(blk_h.transpose(1, 3, 0, 2)).reshape(nbh, bw * n, k)
    blk_w = _blocks_of(mats(w), bw, r, -(-w // bw) + 1)             # (n, nbw, k, bw)
    return rows, blk_w.reshape(-1, k, bw), r, bw


def _blur_banded(x: torch.Tensor, rows, cols, r: int, bw: int,
                 precision: str = "highest") -> torch.Tensor:
    """(..., H, W) -> (..., n, H, W) through :func:`_band_operands`' blocks:
    one pad and two batched products, each over windows of the previous
    result viewed in place (no copy of a window).

    Each frame sits in an (hx, wx) slot, r rows and r columns in from its
    corner (hx = nbh * bw, wx = nbw * bw), padded by replication. A window
    reads past the image only where the blocks hold zeros (the matrices end
    at the image's edge), so any finite value there gives the dense result;
    replication writes every slot value in one kernel. Pass 1 (rows): the
    window of row block ib, slot rows [ib*bw, ib*bw + bw + 2r), times block
    ib transposed, gives its bw output rows for every plane, interleaved by
    row: t[row, plane, column]. Windows run on into the next frame's slot
    (zero blocks meet them), so the frames stack as windows b * nbh + ib;
    the last (an image's trailing zero block) is not computed. Pass 2
    (columns): window (plane p, column block jb) starts p * wx + jb * bw
    floats into each row of t, one stride for every (p, jb); it runs on into
    plane p + 1 (zero rows of the block meet it), and the last, a zero
    block of the last plane, is not computed. The result is laid out as
    (row, plane, column) and returned as a (..., n, H, W) view of it.
    ``rows`` and ``cols`` may be split pairs (at "high"): they index and
    repeat as the f32 blocks do."""
    check_fp32_matmul(x)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    b = math.prod(lead)
    nbh, k = rows.shape[0], rows.shape[2]
    n = rows.shape[1] // bw
    nbw = cols.shape[0] // n
    hx, wx = nbh * bw, nbw * bw
    xr = F.pad(x.reshape(b, h, w), (r, wx - w - r, r, hx - h - r), mode="replicate")
    n_win = b * nbh - 1
    win = xr.as_strided((n_win, k, wx), (bw * wx, wx, 1))
    blocks = rows[:n_win] if b == 1 else rows.repeat(b, 1, 1)[:n_win]
    t = blur_product(blocks, win, precision)                # (n_win, bw * n, wx)
    m, q = n_win * bw, n * nbw - 1
    out = x.new_empty((b * hx, n, wx))
    blur_product(t.as_strided((q, m, k), (bw, n * wx, 1)), cols[:q], precision,
                 out=out.as_strided((q, m, bw), (bw, n * wx, 1)))
    return out.view(b, hx, n, wx).permute(0, 2, 1, 3)[:, :, :h, :w].reshape(*lead, n, h, w)


def blur_bank_banded(base: torch.Tensor, sigmas, bw: int = BAND_WIDTH,
                     precision: str = "highest") -> torch.Tensor:
    """Blocked-band form of the blur bank: (..., H, W) -> (..., len(sigmas),
    H, W), out_s = B^H_s^T @ x @ B^W_s with only the band's blocks
    multiplied (the 2 * ceil(3 sigma) + 1 nonzero diagonals of each matrix,
    one radius for the call: the largest). Each axis is padded up to its
    block grid, so H != W and sides that are not a multiple of ``bw`` work.
    Equal to the dense products up to fp32 summation order. Builds the
    blocks on the host per call; :class:`SiftPyramid` holds them."""
    h, w = base.shape[-2:]
    rows, cols, r, bw = _band_operands(h, w, sigmas, bw)
    as_x = dict(dtype=base.dtype, device=base.device)
    return _blur_banded(base, torch.from_numpy(rows).to(**as_x),
                        torch.from_numpy(cols).to(**as_x), r, bw, precision)


def banded_form(h: int, w: int) -> bool:
    """Whether an (h, w) blur takes the blocked-band form (long side at
    least :data:`_BANDED_MIN_SIZE`) or the dense one."""
    return max(h, w) >= _BANDED_MIN_SIZE


def hold(mat: torch.Tensor, precision: str):
    """A constant blur matrix as its products take it: the f32 matrix at
    "highest", split once into a :class:`SplitPair` at "high" (which is then
    held instead of the f32 copy)."""
    return split_pair(mat) if precision == "high" else mat


class _BlurMatrices(nn.Module):
    """A module holding a blur call's constant matrices as buffers, f32 at
    "highest"; at "high" each is split once, here, and held as its pair's
    parts (one bf16 buffer, no f32 copy), in the layout kernel 5 reads: a
    row pass's bank B^T stored transposed and contiguous (buffer
    ``<name>_t``, :meth:`_hold_row_bank`), where "highest" reads B
    transposed in place."""

    def __init__(self, precision: str):
        super().__init__()
        self.precision = precision
        self._cols: dict[str, int] = {}

    def _hold(self, name: str, mat: torch.Tensor) -> None:
        held = hold(mat, self.precision)
        if isinstance(held, SplitPair):
            self._cols[name] = held.cols
            held = held.parts
        self.register_buffer(name, held)

    def _held(self, name: str):
        """Buffer ``name`` as the products take it."""
        buf = getattr(self, name)
        return SplitPair(buf, self._cols[name]) if name in self._cols else buf

    def _hold_row_bank(self, name: str, mat: torch.Tensor) -> None:
        if self.precision == "high":
            self._hold(name + "_t", mat.transpose(-1, -2).contiguous())
        else:
            self._hold(name, mat)

    def _row_bank(self, name: str):
        """B^T of a bank held by :meth:`_hold_row_bank`."""
        if self.precision == "high":
            return self._held(name + "_t")
        return getattr(self, name).transpose(-1, -2)


class BlurBank(_BlurMatrices):
    """One blur call of the SIFT pyramid on (..., h, w) inputs, its matrices
    held as buffers: the dense Toeplitz pair or, where :func:`banded_form`,
    the band blocks. ``with_input`` puts the input itself first (an octave:
    scale 0, then the blurs). The forward returns (..., n, h, w), every
    product in ``precision``."""

    def __init__(self, h: int, w: int, sigmas, with_input: bool, dtype=torch.float32,
                 device=None, precision: str = "highest"):
        super().__init__(precision)
        self.banded = banded_form(h, w)
        self.with_input = with_input
        if self.banded:
            rows, cols, self.r, self.bw = _band_operands(h, w, sigmas, with_input=with_input)
            self._hold("rows", torch.from_numpy(rows).to(device=device, dtype=dtype))
            self._hold("cols", torch.from_numpy(cols).to(device=device, dtype=dtype))
        else:
            self._hold_row_bank("bank_h", _blur_stack(h, sigmas, dtype, device))
            self._hold("bank_w", _blur_stack(w, sigmas, dtype, device))

    @property
    def form(self) -> str:
        return "banded" if self.banded else "dense"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.banded:
            return _blur_banded(x, self._held("rows"), self._held("cols"), self.r, self.bw,
                                self.precision)
        out = _blur_dense(x, self._row_bank("bank_h"), self._held("bank_w"), self.precision)
        return torch.cat([x[..., None, :, :], out], dim=-3) if self.with_input else out


# ---------------------------------------------------------------------------
# The composite-operator tail (the JAX package's _sift_tail_octaves)
# ---------------------------------------------------------------------------

# Octaves whose long side is at most this come, where more than one octave
# is left, from their first base in one pair of batched products with
# precomposed operators (:class:`TailBank`), as in the JAX package.
_SIFT_TAIL_MAX = 64


def _sift_tail_mats_np(n: int, rel: tuple, sig_s: float, n_tail: int) -> np.ndarray:
    """(n_tail * n_scales, n, n) zero-padded per-axis operator stack: the
    blur -> subsample cascade is linear, so every tail plane is A^T x_t A
    with A a product of blur matrices and even-row selections, composed
    here in float64 (f32 entries, exact f64 products) and rounded once; the
    JAX package's function, line for line, so the stacks are bitwise equal.
    ``sig_s`` is the scale-S relative sigma the cascade blurs with before
    each subsample."""
    mats = []
    M = np.eye(n, dtype=np.float64)
    sz = n
    for o in range(n_tail):
        mats.append(M.copy())  # scale 0: the octave base itself
        for s_rel in rel:
            mats.append(M @ _blur_matrix_np(sz, s_rel).astype(np.float64))
        if o + 1 < n_tail:
            bs = _blur_matrix_np(sz, sig_s).astype(np.float64)
            nxt = -(-sz // 2)
            p = np.zeros((sz, nxt), np.float64)
            p[np.arange(nxt) * 2, np.arange(nxt)] = 1.0
            M = M @ bs @ p
            sz = nxt
    out = np.zeros((len(mats), n, n), np.float32)
    for i, m in enumerate(mats):
        out[i, :, : m.shape[1]] = m.astype(np.float32)
    return out


class TailBank(_BlurMatrices):
    """The last ``n_tail`` octaves of the SIFT pyramid from the first one's
    (h, w) base: every plane ``A_h[p]^T x A_w[p]`` with the operator stacks of
    :func:`_sift_tail_mats_np` held as buffers, two batched products for all
    of them, batched over frames.
    The forward returns the octaves as views of one (..., P, h, w) result,
    (..., S+3, H_o, W_o) each."""

    def __init__(self, h: int, w: int, rel, sig_s: float, n_tail: int,
                 dtype=torch.float32, device=None, precision: str = "highest"):
        super().__init__(precision)
        ah = _sift_tail_mats_np(h, tuple(rel), sig_s, n_tail)
        aw = ah if w == h else _sift_tail_mats_np(w, tuple(rel), sig_s, n_tail)
        self._hold_row_bank("ah", torch.from_numpy(ah).to(device=device, dtype=dtype))
        self._hold("aw", torch.from_numpy(aw).to(device=device, dtype=dtype))
        self.n_scales = len(rel) + 1
        self.shapes = []
        for _ in range(n_tail):
            self.shapes.append((h, w))
            h, w = -(-h // 2), -(-w // 2)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        out = _blur_dense(x, self._row_bank("ah"), self._held("aw"), self.precision)
        n = self.n_scales
        return [out[..., o * n:(o + 1) * n, :h, :w] for o, (h, w) in enumerate(self.shapes)]


class SiftPyramid(nn.Module):
    """SIFT Gaussian pyramid of (height, width) frames with its blur matrices
    held on the device as buffers.

    Octave 0 scale 0 is the input brought from ``assumed_blur`` up to sigma0;
    scales 1..S+2 are composed blurs of the octave base; octave o+1 starts
    from octave o's scale S subsampled by 2 (ceil halving of each side).
    Each blur takes the form :func:`banded_form` names for its shape; from
    the first octave whose long side is at most :data:`_SIFT_TAIL_MAX`, where
    more than one octave is left, the rest come from the :class:`TailBank`
    (:attr:`forms`: the base blur's, then each octave's: "banded", "dense"
    or "tail"). Every product runs in ``cfg.blur_precision``. An octave
    comes back as a view: (S+3, H_o, W_o), its planes interleaved by row
    where banded (:func:`dog_planes` makes a contiguous DoG of it).
    """

    def __init__(self, cfg: PyramidConfig, height: int, width: int | None = None,
                 device=None):
        super().__init__()
        width = height if width is None else width
        self.cfg = cfg
        dt, prec = cfg.dtype, cfg.blur_precision
        base_sigma = math.sqrt(max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12))
        rel = _octave_scale_sigmas(cfg)
        self.shapes: list[tuple[int, int]] = []
        h, w = height, width
        for _ in range(cfg.n_octaves):
            self.shapes.append((h, w))
            h, w = -(-h // 2), -(-w // 2)
        n_oct = len(self.shapes)
        n_head = next((o for o, hw in enumerate(self.shapes)
                       if n_oct - o > 1 and max(hw) <= _SIFT_TAIL_MAX), n_oct)
        self.base = BlurBank(height, width, [base_sigma], False, dt, device, prec)
        self.banks = nn.ModuleList(BlurBank(h, w, rel, True, dt, device, prec)
                                   for h, w in self.shapes[:n_head])
        self.tail = None if n_head == n_oct else TailBank(
            *self.shapes[n_head], rel, rel[cfg.S - 1], n_oct - n_head, dt, device, prec)

    @property
    def forms(self) -> list[str]:
        n_tail = 0 if self.tail is None else len(self.tail.shapes)
        return [self.base.form] + [b.form for b in self.banks] + ["tail"] * n_tail

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        """(H, W) image -> list of (S+3, H_o, W_o) Gaussian octaves; (B, H, W)
        frames -> list of (B, S+3, H_o, W_o), every product batched over B."""
        if img.dim() not in (2, 3) or tuple(img.shape[-2:]) != self.shapes[0]:
            raise ValueError(f"expected {self.shapes[0]} images, got {tuple(img.shape)}")
        check_fp32_matmul(img)
        x = self.base(img.to(self.cfg.dtype))[..., 0, :, :]
        octaves = []
        for bank in self.banks:
            octave = bank(x)
            octaves.append(octave)
            x = strided_subsample(octave[..., self.cfg.S, :, :], 2)
        if self.tail is not None:
            octaves.extend(self.tail(x))
        return octaves


def dog_planes(g: torch.Tensor) -> torch.Tensor:
    """(..., S+3, H, W) Gaussian octave -> (..., S+2, H, W) differences of
    adjacent scales, contiguous whatever the octave's layout (one kernel)."""
    out = g.new_empty((*g.shape[:-3], g.shape[-3] - 1, *g.shape[-2:]))
    return torch.sub(g[..., 1:, :, :], g[..., :-1, :, :], out=out)


def sift_gaussian_pyramid(img: torch.Tensor, cfg: PyramidConfig) -> list[torch.Tensor]:
    """Functional form of :class:`SiftPyramid` (builds the matrices per call)."""
    return SiftPyramid(cfg, img.shape[0], img.shape[1], device=img.device)(img)


def sift_dog_pyramid(img: torch.Tensor, cfg: PyramidConfig) -> list[torch.Tensor]:
    """DoG pyramid for detection: list of (S+2, H_o, W_o) per octave."""
    return [dog_planes(g) for g in sift_gaussian_pyramid(img, cfg)]
