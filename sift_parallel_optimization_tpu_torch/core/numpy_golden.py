"""Pure-NumPy golden model of the reference's behavioural spec (port of
``core/numpy_golden.py``, which the port keeps a copy of: it imports nothing
of the JAX package).

The test oracle: a direct, unoptimised statement of the REFERENCE-mode
semantics (GuassDePyramid.h:60-149), written with explicit loops over the
scales so that it stays obviously right; never on the hot path. The port's
REFERENCE pyramid (the plain version and kernel 1) is held to it.

Semantics pinned (with the reference's lines):
  * octaves: floor(log2(len)) + 1 of them; octave o is the 2^o-strided
    subsample of the ORIGINAL image, and all S+3 scales of an octave start
    equal (GuassDePyramid.h:49-53, 74-86).
  * "filter": a separable multiplicative Gaussian WINDOW, not a
    convolution: element (a, b) is multiplied by f[a] * f[b] with
    f[i] = exp(-(i-c)^2 / (2 sig^2)) / (sig * sqrt(2 PI)), c = (size-1)/2,
    sig = 2.0 / (s+1), PI = 3.1414926 (GuassDePyramid.h:106-134).
  * DoG: ascending in-place subtraction scale[s] -= scale[s+1], equal to
    G[s] - G[s+1] because s+1 is untouched when s is updated
    (GuassDePyramid.h:136-149). Scales 0..S+1 end up holding DoG planes;
    scale S+2 keeps the windowed image.
"""

from __future__ import annotations

import numpy as np

from sift_parallel_optimization_tpu_torch.config import REF_PI, REF_SIGMA, num_octaves


def golden_filter(size: int, s: int) -> np.ndarray:
    """The reference's 1-D Gaussian window for scale index ``s``."""
    sig = REF_SIGMA / (s + 1)
    c = (size - 1) / 2.0
    i = np.arange(size, dtype=np.float32)
    return np.exp(-((i - c) ** 2) / (2.0 * sig * sig)) / (
        sig * np.sqrt(2.0 * REF_PI)
    )


def golden_dog_pyramid(img: np.ndarray, S: int) -> list[np.ndarray]:
    """Full reference pipeline on a square image: one (S+3, size, size)
    float32 array per octave, planes 0..S+1 DoG, plane S+2 the windowed top
    scale (the reference's in-place layout)."""
    img = np.asarray(img)
    assert img.ndim == 2 and img.shape[0] == img.shape[1], "square images only"
    length = img.shape[0]
    out = []
    for o in range(num_octaves(length)):
        step = 2**o
        size = length // step
        base = img[::step, ::step][:size, :size].astype(np.float32)
        scales = np.stack([base.copy() for _ in range(S + 3)])
        for s in range(S + 3):
            f = golden_filter(size, s)
            scales[s] *= f[None, :]  # row pass: element (j, k) *= f[k]
            scales[s] *= f[:, None]  # column pass: element (k, j) *= f[k]
        result = scales.copy()
        for s in range(S + 2):  # ascending, reads the untouched s+1
            result[s] = scales[s] - scales[s + 1]
        out.append(result)
    return out
