"""Configuration of the scale-space / SIFT pipeline (port of ``config.py``).

Same fields and semantics as the JAX ``PyramidConfig``; ``dtype`` is a
``torch.dtype``. ``blur_precision`` picks the arithmetic of the SIFT blur
products: ``"highest"`` full fp32 (the geometry-grade default), ``"high"``
the 3-pass bf16 product on the tensor cores (``ops/blur_product.py``:
detection-grade, not for geometry).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import torch

# The reference's constants (GuassDePyramid.h:7-8). PI is the reference's
# inaccurate literal, kept for parity in REFERENCE mode.
REF_SIGMA = 2.0
REF_PI = 3.1414926


class ScaleSpaceMode(enum.Enum):
    """REFERENCE: multiplicative Gaussian window per scale on 2^o-strided
    subsamples of the original image (the reference study's program).
    SIFT: true Gaussian scale space with sigma_s = sigma0 * 2^(s/S) and an
    octave cascade (Lowe 2004), used by detect/describe."""

    REFERENCE = "reference"
    SIFT = "sift"


def num_octaves(length: int) -> int:
    """floor(log2(length)) + 1: the reference's halving loop down to 1x1."""
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    return length.bit_length()


def octave_sizes(length: int, n_octaves: Optional[int] = None) -> list[int]:
    """Per-octave side lengths (repeated integer halving)."""
    total = num_octaves(length)
    n = total if n_octaves is None else min(n_octaves, total)
    return [length >> o for o in range(n)]


# The blur products' arithmetic: full fp32, or the 3-pass bf16 product.
BLUR_PRECISIONS = ("highest", "high")

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Static configuration of one pyramid computation.

    length: square image side (sets the octave count).
    S: DoG intervals usable for extrema; S+3 Gaussian scales, S+2 DoG planes.
    mode: REFERENCE or SIFT.
    sigma0, assumed_blur: SIFT base sigma and the blur already in the input.
    max_octaves: optional cap on the octave count.
    min_octave_size: smallest octave side computed in SIFT mode.
    dtype: compute dtype of the pyramid.
    blur_precision: arithmetic of the SIFT blur products. "highest"
      (default): full fp32, what geometry needs (the SfM and odometry gates
      were read on it). "high": each f32 operand split into two bf16 parts,
      three bf16 products on the card's tensor cores with fp32 accumulation
      (kernel 5, ``ops/blur_product.py``): ~1e-5 blur error, detection-grade,
      not for geometry. "default" (one bf16 pass) is refused: its ~1e-3 blur
      error injects spurious DoG extrema.
    """

    length: int = 512
    S: int = 2
    mode: ScaleSpaceMode = ScaleSpaceMode.REFERENCE
    sigma0: float = 1.6
    assumed_blur: float = 0.5
    max_octaves: Optional[int] = None
    min_octave_size: int = 8
    dtype: torch.dtype = torch.float32
    blur_precision: str = "highest"

    def __post_init__(self):
        if self.blur_precision not in BLUR_PRECISIONS:
            raise ValueError(
                f"blur_precision must be one of {sorted(BLUR_PRECISIONS)} "
                f"(got {self.blur_precision!r}); 1-pass bf16 'default' is "
                "rejected: it injects spurious DoG extrema"
            )

    @property
    def n_scales(self) -> int:
        return self.S + 3

    @property
    def n_dog(self) -> int:
        return self.S + 2

    @property
    def n_octaves(self) -> int:
        total = num_octaves(self.length)
        if self.mode is ScaleSpaceMode.SIFT:
            usable = max(
                1, int(math.log2(max(self.length // self.min_octave_size, 1))) + 1
            )
            total = min(total, usable)
        if self.max_octaves is not None:
            total = min(total, self.max_octaves)
        return total

    @property
    def sizes(self) -> list[int]:
        return octave_sizes(self.length, self.n_octaves)

    def sift_sigmas(self) -> list[float]:
        """Per-scale absolute sigmas within one octave (SIFT mode)."""
        k = 2.0 ** (1.0 / self.S)
        return [self.sigma0 * (k**s) for s in range(self.n_scales)]


def config_from_jax_fields(d: dict) -> PyramidConfig:
    """Port config from the fields of a JAX ``PyramidConfig``.

    ``d`` is ``dataclasses.asdict`` of the JAX config with ``dtype`` given as
    a numpy dtype name (e.g. ``"float32"``); ``mode`` may be either
    package's enum member or its string value.
    """
    d = dict(d)
    mode = d.get("mode", ScaleSpaceMode.REFERENCE)
    d["mode"] = ScaleSpaceMode(getattr(mode, "value", mode))
    if "dtype" in d:
        name = str(d["dtype"])
        if name not in _DTYPES:
            raise ValueError(f"unsupported dtype {name!r}")
        d["dtype"] = _DTYPES[name]
    return PyramidConfig(**d)
