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
from sift_parallel_optimization_tpu.core import numpy_golden as jgolden
from sift_parallel_optimization_tpu.core import pyramid_ref as jpr
from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization_tpu_torch.core import numpy_golden as tgolden
from sift_parallel_optimization_tpu_torch.core import pyramid_ref as tpr
from sift_parallel_optimization_tpu_torch.ops import scale_space as tss
from sift_parallel_optimization_tpu_torch.utils import native as tnative

# REFERENCE tolerance of tests/test_scale_space_pallas.py: the Pallas body
# computes prev - g where the jnp form computes base * (W_s - W_{s+1}), so
# the two agree to f32 rounding, not bitwise.
REF_RTOL, REF_ATOL = 1e-5, 1e-6
# SIFT: both packages compute the same products (dense or banded blurs down
# to the octaves of side <= 64, then the composite tail from the same
# operator stacks), which may sum in another order in XLA and in PyTorch;
# 1e-5 on [0, 1] frames leaves room for that order over an octave cascade.
SIFT_ATOL = 1e-5
# The tail octaves alone: one pair of products from a base that itself
# agrees to f32 rounding (the CPU runs of this tree read them bitwise equal).
TAIL_ATOL = 1e-6


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


@pytest.mark.parametrize("size", [64, 256, 512])
def test_sift_pyramid_matches_jax(size):
    """512^2: the JAX package's banded blurs (its cutoff) against the port's
    form for that size."""
    img = tnative.synth_frame(size, 0, seed=1)
    jcfg = JaxConfig(length=size, S=3, mode=JaxMode.SIFT)
    tcfg = PyramidConfig(length=size, S=3, mode=ScaleSpaceMode.SIFT)
    want = jax.jit(lambda x: jpr.sift_gaussian_pyramid(x, jcfg))(jnp.asarray(img))
    got = tpr.sift_gaussian_pyramid(torch.from_numpy(img.copy()), tcfg)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for o, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=SIFT_ATOL,
                                   err_msg=f"octave {o}")
    dogs = tpr.sift_dog_pyramid(torch.from_numpy(img.copy()), tcfg)
    for g, d in zip(got, dogs):
        torch.testing.assert_close(d, g[1:] - g[:-1], rtol=0, atol=0)


def test_sift_pyramid_rectangular_matches_jax():
    _rectangular_matches_jax(48, 80, 2)


def test_sift_pyramid_kitti_shape_matches_jax():
    """376 x 1241 (KITTI's frames): banded in both packages on both axes,
    neither side a multiple of 64."""
    _rectangular_matches_jax(376, 1241, 3)


def _rectangular_matches_jax(h, w, S):
    img = np.random.default_rng(3).random((h, w), dtype=np.float32)
    jcfg = JaxConfig(length=h, S=S, mode=JaxMode.SIFT)
    tcfg = PyramidConfig(length=h, S=S, mode=ScaleSpaceMode.SIFT)
    want = jax.jit(lambda x: jpr.sift_gaussian_pyramid(x, jcfg))(jnp.asarray(img))
    got = tpr.SiftPyramid(tcfg, h, w)(torch.from_numpy(img))
    assert [tuple(g.shape) for g in got] == [tuple(o.shape) for o in want]
    for g, o in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(o), rtol=0, atol=SIFT_ATOL)


# The blocked-band blur: the JAX package's own bound
# (tests/test_pyramid_ref.py:158-215): the band blocks hold exactly the
# dense matrices' nonzeros, so the two agree up to f32 summation order.
BANDED_ATOL = 2e-6


@pytest.mark.parametrize("h,w", [(512, 512), (384, 1280), (376, 1241)])
def test_blur_bank_banded_matches_dense_and_jax(h, w):
    cfg = PyramidConfig(length=w, S=3, mode=ScaleSpaceMode.SIFT)
    sigmas = tpr._octave_scale_sigmas(cfg)
    img = np.random.default_rng(h + w).random((h, w), dtype=np.float32)
    x = torch.from_numpy(img)
    got = tpr.blur_bank_banded(x, sigmas)
    dense = tpr.blur_bank(x, tpr._blur_stack(h, sigmas, torch.float32, "cpu"),
                          tpr._blur_stack(w, sigmas, torch.float32, "cpu"))
    assert got.shape == dense.shape == (len(sigmas), h, w)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=BANDED_ATOL)
    want = jax.jit(lambda a: jpr.blur_bank_banded(a, sigmas))(jnp.asarray(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=BANDED_ATOL)
    # The band blocks are the JAX package's, entry for entry.
    r = max(tpr._taps_np(s)[0] for s in sigmas)
    np.testing.assert_array_equal(tpr._band_blocks_np(w, sigmas, 64, r),
                                  jpr._band_blocks_np(w, sigmas, 64, r))


@pytest.mark.parametrize("h,w", [(512, 512), (376, 1241), (200, 100)])
def test_sift_pyramid_blurs_take_the_dispatched_form(monkeypatch, h, w):
    """Every blur of the pyramid takes the form its shape names, on one frame
    and on a batch of two, down to the first octave of side <= 64 with more
    than one octave left, from which the tail takes them; the all-dense
    pyramid (cutoff out of reach) agrees within the banded bound, and scale
    0 of every octave down to the tail's first is its base exactly."""
    cfg = PyramidConfig(length=h, S=3, mode=ScaleSpaceMode.SIFT)
    frames = torch.from_numpy(np.random.default_rng(5).random((2, h, w), dtype=np.float32))
    pyr = tpr.SiftPyramid(cfg, h, w)
    n = len(pyr.shapes)
    head = next((o for o, hw in enumerate(pyr.shapes)
                 if n - o > 1 and max(hw) <= tpr._SIFT_TAIL_MAX), n)
    sides = [(h, w)] + pyr.shapes[:head]
    assert pyr.forms == (["banded" if tpr.banded_form(*hw) else "dense" for hw in sides]
                         + ["tail"] * (n - head))
    assert pyr.forms[0] == ("banded" if max(h, w) >= tpr._BANDED_MIN_SIZE else "dense")
    got, batch = pyr(frames[1]), pyr(frames)
    monkeypatch.setattr(tpr, "_BANDED_MIN_SIZE", 1 << 30)
    dense = tpr.SiftPyramid(cfg, h, w)
    assert set(dense.forms) == {"dense"} | ({"tail"} if head < n else set())
    want = dense(frames[1])
    for o, (g, b, d) in enumerate(zip(got, batch, want)):
        assert g.shape == b.shape[1:] == d.shape == (cfg.S + 3, *pyr.shapes[o])
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=0, atol=BANDED_ATOL, err_msg=f"{o}")
        np.testing.assert_allclose(b[1].numpy(), g.numpy(), rtol=0, atol=BANDED_ATOL)
        if o < head and o + 1 < len(got):
            assert torch.equal(got[o + 1][0], g[cfg.S, ::2, ::2])
    dogs = tpr.sift_dog_pyramid(frames[1], cfg)
    assert all(d.is_contiguous() for d in dogs)


@pytest.mark.parametrize("sigma", [1.6, 3.7])
@pytest.mark.parametrize("shape", [(64, 48), (2, 37, 29)])
def test_separable_blur_matches_jax(shape, sigma):
    img = np.random.default_rng(7).random(shape, dtype=np.float32)
    taps = tpr.gaussian_kernel_1d(sigma)
    want = jax.jit(jpr.separable_blur)(jnp.asarray(img), jnp.asarray(taps.numpy()))
    got = tpr.separable_blur(torch.from_numpy(img), taps)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SIFT_ATOL)


@pytest.mark.parametrize("step", [1, 2, 4])
def test_strided_subsample_matches_jax(step):
    img = np.random.default_rng(8).normal(size=(37, 29)).astype(np.float32)
    want = np.asarray(jax.jit(jpr.strided_subsample, static_argnums=1)(jnp.asarray(img), step))
    got = tpr.strided_subsample(torch.from_numpy(img), step).numpy()
    assert got.shape == want.shape == (-(-37 // step), -(-29 // step))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The composite-operator tail and the NumPy golden model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,S,n_tail", [(64, 3, 4), (47, 2, 3), (16, 3, 2), (64, 5, 1)])
def test_sift_tail_mats_equal_jax(n, S, n_tail):
    """The operator stacks: the same float64 composition, bit for bit."""
    rel = tuple(tpr._octave_scale_sigmas(PyramidConfig(length=512, S=S, mode=ScaleSpaceMode.SIFT)))
    got = tpr._sift_tail_mats_np(n, rel, rel[S - 1], n_tail)
    assert got.shape == (n_tail * (S + 3), n, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jpr._sift_tail_mats_np(n, rel, rel[S - 1], n_tail))


@pytest.mark.parametrize("size", [256, 512])
def test_sift_tail_octaves_match_jax_single_and_batched(size):
    """The octaves of side <= 64 come from the tail in both packages: within
    TAIL_ATOL of JAX's, one frame a call and two frames in one call."""
    cfg = PyramidConfig(length=size, S=3, mode=ScaleSpaceMode.SIFT)
    jcfg = JaxConfig(length=size, S=3, mode=JaxMode.SIFT)
    frames = np.stack([tnative.synth_frame(size, i, seed=2) for i in range(2)])
    pyr = tpr.SiftPyramid(cfg, size)
    assert pyr.tail is not None and pyr.forms.count("tail") == len(pyr.tail.shapes) == 4
    batch = pyr(torch.from_numpy(frames))
    jfn = jax.jit(lambda x: jpr.sift_gaussian_pyramid(x, jcfg))
    for i in range(2):
        want = jfn(jnp.asarray(frames[i]))
        one = pyr(torch.from_numpy(frames[i].copy()))
        tail = [o for o, w in enumerate(want) if w.shape[-1] <= tpr._SIFT_TAIL_MAX]
        assert len(tail) == 4
        for o in tail:
            for got in (one[o], batch[o][i]):
                assert got.shape == want[o].shape
                np.testing.assert_allclose(got.numpy(), np.asarray(want[o]), rtol=0,
                                           atol=TAIL_ATOL, err_msg=f"frame {i} octave {o}")


@pytest.mark.parametrize("size,S", [(32, 2), (64, 3), (128, 2)])
def test_golden_dog_pyramid_matches_jax_and_the_plain_pyramid(size, S):
    """The port's copy of the NumPy oracle equals the JAX package's bit for
    bit, and the port's REFERENCE plain pyramid matches it within the
    REFERENCE tolerance (the plain version computes base * (W_s - W_s+1)
    where the oracle subtracts windowed planes)."""
    img = np.random.default_rng(size + S).random((size, size), dtype=np.float32)
    got = tgolden.golden_dog_pyramid(img, S)
    want = jgolden.golden_dog_pyramid(img, S)
    assert len(got) == len(want) == tpr.num_octaves(size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    for s in range(S + 3):
        np.testing.assert_array_equal(tgolden.golden_filter(size, s),
                                      jgolden.golden_filter(size, s))
    plain = tss.reference_dog_pyramid_plain(torch.from_numpy(img), S)
    for o, (p, g) in enumerate(zip(plain, got)):
        np.testing.assert_allclose(p.numpy(), g, rtol=REF_RTOL, atol=REF_ATOL,
                                   err_msg=f"octave {o}")
