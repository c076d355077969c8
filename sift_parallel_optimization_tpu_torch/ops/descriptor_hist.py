"""SIFT descriptor histograms: wrapper of the CUDA kernel and its plain version.

Kernel: ``csrc/descriptor_hist.cu`` (kernel 6; it replaces no Pallas kernel:
the JAX package's ``models/descriptor._descriptors_from_samples`` and
``_normalize_desc`` are jnp, fused by XLA). Per keypoint slot, from its
``(26, 26)`` descriptor sample grid, the grid's ``(26,)`` offsets, sigma in
octave pixels and one or two ``(theta, valid)`` orientations: Lowe's 4x4x8
trilinear histogram at each orientation, L2-normalised, clipped at 0.2 and
renormalised, a zero row where the orientation is invalid.

:func:`descriptor_hist` takes the per-slot inputs with the keypoints'
leading axes, ``(K,)`` or ``(B, K)``, and returns ``(..., n * K, 128)``:
orientation ``i`` of slot ``k`` in row ``i * K + k`` of its frame, the
layout ``models/descriptor.orient_and_describe`` returns. A CPU tensor
takes :func:`descriptor_hist_plain`; a CUDA tensor takes the kernel, one
launch for every frame and orientation, or raises.
"""

from __future__ import annotations

import math

import torch

from sift_parallel_optimization_tpu_torch.ops._build import check_launch, load_kernels

# Kernel launches made by descriptor_hist_cuda (read by chip_smoke.py).
LAUNCHES = 0

DESC_WIDTH = 4             # 4x4 spatial bins
DESC_ORI_BINS = 8
DESC_GRID = 26             # samples per axis (24x24 usable gradients)
DESC_BIN_SIGMA = 3.0       # spatial bin width = 3 * sigma_o (Lowe 2004)
DESC_CLIP = 0.2
DESC_DIM = DESC_WIDTH * DESC_WIDTH * DESC_ORI_BINS


def grid_gradients(samples: torch.Tensor):
    """(K, G, G) -> (gy, gx) central differences, (K, G-2, G-2)."""
    gy = (samples[:, 2:, 1:-1] - samples[:, :-2, 1:-1]) / 2
    gx = (samples[:, 1:-1, 2:] - samples[:, 1:-1, :-2]) / 2
    return gy, gx


def _descriptors_from_samples(samples, offsets, sig_o, theta):
    """(K, 128) raw descriptor histograms from the (K, 26, 26) samples."""
    d = DESC_WIDTH
    g = DESC_GRID
    k = samples.shape[0]
    bin_w = DESC_BIN_SIGMA * sig_o
    gy, gx = grid_gradients(samples)
    p = (g - 2) * (g - 2)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(k, p)
    ang = torch.atan2(gy, gx).reshape(k, p) - theta[:, None]

    du = offsets[:, 1:-1]
    dy = du[:, :, None].expand(k, g - 2, g - 2).reshape(k, p)
    dx = du[:, None, :].expand(k, g - 2, g - 2).reshape(k, p)
    cos_t, sin_t = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    inv_bw = 1.0 / torch.clamp(bin_w, min=1e-6)[:, None]
    u = (cos_t * dy - sin_t * dx) * inv_bw            # rotated row, bin units
    v = (sin_t * dy + cos_t * dx) * inv_bw            # rotated col, bin units
    w = mag * torch.exp(-(u * u + v * v) / (0.5 * d * d))

    rbin = u + d / 2.0 - 0.5
    cbin = v + d / 2.0 - 0.5
    obin = torch.remainder(ang, 2 * math.pi) / (2 * math.pi) * DESC_ORI_BINS

    # Trilinear voting as separable hat-weight vectors (no one-hot).
    dev = samples.device
    bins_rc = torch.arange(d, dtype=torch.float32, device=dev)
    wr = torch.clamp(1.0 - (rbin[..., None] - bins_rc).abs(), min=0.0)
    wc = torch.clamp(1.0 - (cbin[..., None] - bins_rc).abs(), min=0.0)
    bins_o = torch.arange(DESC_ORI_BINS, dtype=torch.float32, device=dev)
    do = (obin[..., None] - bins_o).abs()
    do = torch.minimum(do, DESC_ORI_BINS - do)
    wo = torch.clamp(1.0 - do, min=0.0)

    t = ((w[..., None] * wr)[..., :, None] * wc[..., None, :]).reshape(k, p, d * d)
    return torch.bmm(t.transpose(1, 2), wo).reshape(k, DESC_DIM)


def _normalize_desc(hist: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(hist, dim=-1, keepdim=True)
    desc = hist / torch.clamp(norm, min=1e-7)
    desc = torch.clamp(desc, max=DESC_CLIP)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-7)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def _check(samples, offsets, sig_o, orientations) -> None:
    """Shapes, dtypes, one device and contiguity, else ValueError."""
    slots = tuple(samples.shape[:-2])
    if (samples.dim() not in (3, 4) or tuple(samples.shape[-2:]) != (DESC_GRID, DESC_GRID)
            or tuple(offsets.shape) != (*slots, DESC_GRID) or tuple(sig_o.shape) != slots
            or len(orientations) not in (1, 2)
            or any(tuple(t.shape) != slots or tuple(v.shape) != slots
                   for t, v in orientations)):
        raise ValueError(
            f"expected (..., K, {DESC_GRID}, {DESC_GRID}) samples with (K,) or (B, K) slots, "
            f"(..., K, {DESC_GRID}) offsets, and (..., K) sigma and one or two (theta, valid), "
            f"got {tuple(samples.shape)}, {tuple(offsets.shape)}, {tuple(sig_o.shape)}, "
            f"{[(tuple(t.shape), tuple(v.shape)) for t, v in orientations]}"
        )
    floats = (samples, offsets, sig_o, *(t for t, _v in orientations))
    masks = tuple(v for _t, v in orientations)
    if (any(t.dtype != torch.float32 for t in floats)
            or any(v.dtype != torch.bool for v in masks)):
        raise ValueError(
            f"expected f32 samples, offsets, sigma and theta and bool valid, got "
            f"{[t.dtype for t in floats]}, {[v.dtype for v in masks]}"
        )
    if any(t.device != samples.device for t in (*floats, *masks)):
        raise ValueError("samples, offsets, sigma, theta and valid must be on one device")
    if not all(t.is_contiguous() for t in (*floats, *masks)):
        raise ValueError("samples, offsets, sigma, theta and valid must be contiguous")


def descriptor_hist_plain(
    samples: torch.Tensor, offsets: torch.Tensor, sig_o: torch.Tensor, orientations
) -> torch.Tensor:
    """The PyTorch composition, one orientation at a time:
    :func:`_descriptors_from_samples`, :func:`_normalize_desc`, then the
    orientations' rows side by side."""
    _check(samples, offsets, sig_o, orientations)
    slots = tuple(samples.shape[:-2])
    flat_s = samples.reshape(-1, DESC_GRID, DESC_GRID)
    flat_o, flat_sig = offsets.reshape(-1, DESC_GRID), sig_o.reshape(-1)
    descs = [
        _normalize_desc(
            _descriptors_from_samples(flat_s, flat_o, flat_sig, theta.reshape(-1)),
            valid.reshape(-1),
        ).reshape(*slots, DESC_DIM)
        for theta, valid in orientations
    ]
    return descs[0] if len(descs) == 1 else torch.cat(descs, dim=-2)


def descriptor_hist_cuda(
    samples: torch.Tensor, offsets: torch.Tensor, sig_o: torch.Tensor, orientations
) -> torch.Tensor:
    """The kernel: every frame and orientation in one launch."""
    global LAUNCHES
    _check(samples, offsets, sig_o, orientations)
    dev = samples.device
    if not samples.is_cuda:
        raise ValueError("samples, offsets, sigma, theta and valid must be CUDA tensors")
    *lead, k = samples.shape[:-2]
    n = len(orientations)
    out = torch.empty((*lead, n * k, DESC_DIM), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    (theta1, valid1), (theta2, valid2) = orientations[0], orientations[-1]
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_descriptor_hist(
            samples.data_ptr(), offsets.data_ptr(), sig_o.data_ptr(), theta1.data_ptr(),
            valid1.data_ptr(), theta2.data_ptr(), valid2.data_ptr(), sig_o.numel(), k, n,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(rc, "sift_descriptor_hist")
    LAUNCHES += 1
    return out


def descriptor_hist(
    samples: torch.Tensor, offsets: torch.Tensor, sig_o: torch.Tensor, orientations
) -> torch.Tensor:
    """Dispatch on the samples' device: CPU -> plain, CUDA -> kernel.

    ``samples`` (..., K, 26, 26), ``offsets`` (..., K, 26), ``sig_o`` (..., K)
    and ``orientations``, one or two ``(theta, valid)`` pairs of (..., K) f32
    and bool tensors, where ``...`` is () or (B,) -> (..., n * K, 128)."""
    if samples.device.type == "cpu":
        return descriptor_hist_plain(samples, offsets, sig_o, orientations)
    if samples.device.type == "cuda":
        return descriptor_hist_cuda(samples, offsets, sig_o, orientations)
    raise ValueError(f"unsupported device {samples.device}")
