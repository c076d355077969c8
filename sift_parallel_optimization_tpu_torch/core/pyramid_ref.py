"""Scale-space pyramids in PyTorch (port of ``core/pyramid_ref.py``).

* REFERENCE mode: the reference study's program. Each octave is the
  2^o-strided subsample of the original image times a separable Gaussian
  window per scale, with adjacent-scale DoG (GuassDePyramid.h:60-149). On a
  CUDA tensor :func:`reference_dog_pyramid` is one launch of the fused kernel
  in ``ops/scale_space.py``; the functions here are its plain version.
* SIFT mode: a true Gaussian scale space. Blurs are dense edge-clamped
  Toeplitz products ``B_h^T X B_w`` in full fp32 (``torch.matmul``; no cuDNN
  convolution, which defaults to TF32 on Hopper), the octave cascade is the
  plain blur -> subsample loop, and the blur matrices live on the device as
  buffers of :class:`SiftPyramid`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from sift_parallel_optimization_tpu_torch.config import (
    REF_PI,
    REF_SIGMA,
    PyramidConfig,
    num_octaves,
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
    # sqrt in f32 of the f32-rounded constant, as the JAX expression does.
    root = torch.sqrt(torch.tensor(2.0 * REF_PI, dtype=f32, device=device))
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


def reference_subsample(img: torch.Tensor, octave: int) -> torch.Tensor:
    """Octave base: the 2^o-strided subsample of the ORIGINAL image."""
    step = 2**octave
    size = img.shape[0] // step
    return img[::step, ::step][:size, :size]


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


def _octave_scale_sigmas(cfg: PyramidConfig) -> list[float]:
    """Composed sigmas: the blur applied to the octave BASE to reach scale s
    (Gaussian semigroup: sqrt(sig_s^2 - sigma0^2))."""
    sig = cfg.sift_sigmas()
    return [
        math.sqrt(max(sig[s] ** 2 - sig[0] ** 2, 1e-12))
        for s in range(1, cfg.n_scales)
    ]


def _blur_matrix_np(size: int, sigma: float) -> np.ndarray:
    """(size, size) f32 Toeplitz matrix with edge-clamped Gaussian taps."""
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-(x**2) / (2.0 * sigma * sigma))
    taps = (taps / taps.sum()).astype(np.float32)
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


def blur_bank(x: torch.Tensor, bank_h: torch.Tensor, bank_w: torch.Tensor) -> torch.Tensor:
    """(H, W) image -> (S', H, W): out_s = B^H_s^T @ x @ B^W_s. (B, H, W)
    frames -> (B, S', H, W): the same products broadcast over the frames."""
    if x.dim() == 3:
        x = x[:, None]
    return bank_h.transpose(-1, -2) @ (x @ bank_w)


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


class SiftPyramid(nn.Module):
    """SIFT Gaussian pyramid of (height, width) frames with its blur matrices
    held on the device as buffers.

    Octave 0 scale 0 is the input brought from ``assumed_blur`` up to sigma0;
    scales 1..S+2 are composed blurs of the octave base; octave o+1 starts
    from octave o's scale S subsampled by 2 (ceil halving of each side).
    """

    def __init__(self, cfg: PyramidConfig, height: int, width: int | None = None,
                 device=None):
        super().__init__()
        width = height if width is None else width
        self.cfg = cfg
        dt = cfg.dtype
        base_sigma = math.sqrt(max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12))
        rel = _octave_scale_sigmas(cfg)
        self.shapes: list[tuple[int, int]] = []
        h, w = height, width
        for _ in range(cfg.n_octaves):
            self.shapes.append((h, w))
            h, w = -(-h // 2), -(-w // 2)
        self.register_buffer("base_h", _blur_stack(height, [base_sigma], dt, device))
        self.register_buffer("base_w", _blur_stack(width, [base_sigma], dt, device))
        for o, (h, w) in enumerate(self.shapes):
            self.register_buffer(f"bank_h{o}", _blur_stack(h, rel, dt, device))
            self.register_buffer(f"bank_w{o}", _blur_stack(w, rel, dt, device))

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        """(H, W) image -> list of (S+3, H_o, W_o) Gaussian octaves; (B, H, W)
        frames -> list of (B, S+3, H_o, W_o), every product batched over B."""
        if img.dim() not in (2, 3) or tuple(img.shape[-2:]) != self.shapes[0]:
            raise ValueError(f"expected {self.shapes[0]} images, got {tuple(img.shape)}")
        check_fp32_matmul(img)
        x = blur_bank(img.to(self.cfg.dtype), self.base_h, self.base_w)[..., 0, :, :]
        octaves = []
        for o in range(len(self.shapes)):
            bh, bw = getattr(self, f"bank_h{o}"), getattr(self, f"bank_w{o}")
            octave = torch.cat([x[..., None, :, :], blur_bank(x, bh, bw)], dim=-3)
            octaves.append(octave)
            x = octave[..., self.cfg.S, ::2, ::2]
        return octaves


def sift_gaussian_pyramid(img: torch.Tensor, cfg: PyramidConfig) -> list[torch.Tensor]:
    """Functional form of :class:`SiftPyramid` (builds the matrices per call)."""
    return SiftPyramid(cfg, img.shape[0], img.shape[1], device=img.device)(img)


def sift_dog_pyramid(img: torch.Tensor, cfg: PyramidConfig) -> list[torch.Tensor]:
    """DoG pyramid for detection: list of (S+2, H_o, W_o) per octave."""
    return [g[1:] - g[:-1] for g in sift_gaussian_pyramid(img, cfg)]
