"""The port's REFERENCE and SIFT pyramids against the JAX package on CPU.

Inputs come from numpy and go to both packages. The JAX Pallas octave
kernel runs in TPU interpret mode, as tests/test_scale_space_pallas.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_parallel_optimization_tpu.ops.scale_space_pallas as jssp
from sift_parallel_optimization_tpu.config import PyramidConfig as JaxConfig
from sift_parallel_optimization_tpu.config import ScaleSpaceMode as JaxMode
from sift_parallel_optimization_tpu.core import pyramid_ref as jpr
from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization_tpu_torch.core import pyramid_ref as tpr
from sift_parallel_optimization_tpu_torch.ops import scale_space as tss
from sift_parallel_optimization_tpu_torch.utils import native as tnative

# REFERENCE tolerance of tests/test_scale_space_pallas.py: the Pallas body
# computes prev - g where the jnp form computes base * (W_s - W_{s+1}), so
# the two agree to f32 rounding, not bitwise.
REF_RTOL, REF_ATOL = 1e-5, 1e-6
# SIFT: the JAX tail octaves (<= 64^2) use precomposed operators, within
# ~1e-7 of the port's plain blur -> subsample cascade (their docstring);
# 1e-5 leaves room for f32 summation order in the dense products.
SIFT_ATOL = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jssp, "_MIN_PALLAS_SIZE", 0)
    with pltpu.force_tpu_interpret_mode():
        yield


def test_filter_bank_matches_jax():
    bank = jax.jit(jpr.reference_filter_bank, static_argnums=(0, 1))
    for size, n in ((100, 5), (128, 6)):
        want = np.asarray(bank(size, n))
        got = tpr.reference_filter_bank(size, n).numpy()
        # Same f32 expression; exp may differ by an ulp between libraries,
        # and XLA on the CPU flushes subnormal results to zero where torch
        # keeps them (atol = the smallest normal f32).
        np.testing.assert_allclose(
            got, want, rtol=REF_RTOL, atol=np.finfo(np.float32).tiny
        )


@pytest.mark.parametrize("size,S", [(16, 1), (32, 2), (64, 3), (128, 2)])
def test_reference_octave_matches_jax_and_pallas(size, S, rng, interpret_mode):
    base = rng.normal(size=(size, size)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jpr.reference_dog_octave(x, S))(jnp.asarray(base)))
    pallas = np.asarray(jssp.reference_dog_octave_pallas(jnp.asarray(base), S + 3))
    got = tpr.reference_dog_octave(torch.from_numpy(base), S).numpy()
    np.testing.assert_allclose(got, want, rtol=REF_RTOL, atol=REF_ATOL)
    np.testing.assert_allclose(got, pallas, rtol=REF_RTOL, atol=REF_ATOL)


@pytest.mark.parametrize("size,S", [(16, 3), (64, 1), (128, 2)])
def test_reference_pyramid_matches_jax_and_pallas(size, S, rng, interpret_mode):
    img = rng.random((size, size), dtype=np.float32)
    want = jax.jit(lambda x: jpr.reference_dog_pyramid(x, S))(jnp.asarray(img))
    pallas = jax.jit(lambda x: jssp.reference_dog_pyramid_pallas(x, S))(
        jnp.asarray(img)
    )
    got = tpr.reference_dog_pyramid(torch.from_numpy(img), S)
    assert len(got) == len(want) == len(pallas)
    for o, (g, w, p) in enumerate(zip(got, want, pallas)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REF_RTOL,
                                   atol=REF_ATOL, err_msg=f"octave {o}")
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=REF_RTOL,
                                   atol=REF_ATOL, err_msg=f"octave {o}")


@pytest.mark.parametrize("size", [500, 768])
def test_reference_pyramid_ragged_sides_match_jax(size, rng):
    """Sides that are no power of two: the octave chain halves with a floor
    (500 -> 250 -> 125 -> 62 ...; 768 -> ... -> 12 -> 6 -> 3 -> 1), which is
    where the CUDA kernel leaves its 16-byte path. The plain version here and
    the kernel on the card must both give what the JAX package defines per
    octave: reference_dog_octave of the 2^o-strided subsample of the image."""
    img = rng.random((size, size), dtype=np.float32)
    got = tss.reference_dog_pyramid(torch.from_numpy(img), 2)
    assert [g.shape[-1] for g in got] == [size >> o for o in range(size.bit_length())]
    octave = jax.jit(lambda x, o: jpr.reference_dog_octave(jpr.reference_subsample(x, o), 2),
                     static_argnums=1)
    for o, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(octave(jnp.asarray(img), o)),
                                   rtol=REF_RTOL, atol=REF_ATOL, err_msg=f"octave {o}")
    if size == 768:
        # The JAX package's whole pipeline batches its octaves under 64^2 from
        # the last larger base; at 500 that batch differs from its own
        # per-octave definition at sides 7 and 3, so only 768 is held to it.
        want = jax.jit(lambda x: jpr.reference_dog_pyramid(x, 2))(jnp.asarray(img))
        assert len(want) == len(got)
        for o, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REF_RTOL, atol=REF_ATOL,
                                       err_msg=f"pipeline octave {o}")


def test_reference_pyramid_truncated_octaves(rng):
    img = rng.random((64, 64), dtype=np.float32)
    got = tpr.reference_dog_pyramid(torch.from_numpy(img), 2, n_octaves=3)
    want = jax.jit(lambda x: jpr.reference_dog_pyramid(x, 2, n_octaves=3))(
        jnp.asarray(img)
    )
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REF_RTOL, atol=REF_ATOL)


def test_gaussian_kernel_1d_matches_jax():
    for sigma in (0.3, 1.6, 3.7):
        want = np.asarray(jpr.gaussian_kernel_1d(sigma))
        got = tpr.gaussian_kernel_1d(sigma).numpy()
        # f32 exp and sum on both sides; an ulp apart at most.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_blur_matrix_matches_jax():
    for size, sigma in ((64, 1.2), (37, 2.5), (8, 4.0)):
        # The same numpy construction: bitwise equal.
        np.testing.assert_array_equal(
            tpr.blur_matrix(size, sigma).numpy(), np.asarray(jpr.blur_matrix(size, sigma))
        )


@pytest.mark.parametrize("size", [64, 256])
def test_sift_pyramid_matches_jax(size):
    img = tnative.synth_frame(size, 0, seed=1)
    jcfg = JaxConfig(length=size, S=3, mode=JaxMode.SIFT)
    tcfg = PyramidConfig(length=size, S=3, mode=ScaleSpaceMode.SIFT)
    want = jpr.sift_gaussian_pyramid(jnp.asarray(img), jcfg)
    got = tpr.sift_gaussian_pyramid(torch.from_numpy(img.copy()), tcfg)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for o, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=SIFT_ATOL,
                                   err_msg=f"octave {o}")
    dogs = tpr.sift_dog_pyramid(torch.from_numpy(img.copy()), tcfg)
    for g, d in zip(got, dogs):
        torch.testing.assert_close(d, g[1:] - g[:-1], rtol=0, atol=0)


def test_sift_pyramid_rectangular_matches_jax():
    img = np.random.default_rng(3).random((48, 80), dtype=np.float32)
    jcfg = JaxConfig(length=48, S=2, mode=JaxMode.SIFT)
    tcfg = PyramidConfig(length=48, S=2, mode=ScaleSpaceMode.SIFT)
    want = jpr.sift_gaussian_pyramid(jnp.asarray(img), jcfg)
    got = tpr.SiftPyramid(tcfg, 48, 80)(torch.from_numpy(img))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=SIFT_ATOL)
