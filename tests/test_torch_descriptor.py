"""The port's patch gather, atlas and descriptors against the JAX package.

The descriptor stage runs on the JAX detector's own keypoints (passed in
through ``keypoints_from_numpy``), which isolates description from
detection. The JAX Pallas gather runs in TPU interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.core import pyramid_ref as jpr
from sift_parallel_optimization_tpu.models import descriptor as jdesc
from sift_parallel_optimization_tpu.models import detect as jdet
from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu.ops import patch_gather as jpg
from sift_parallel_optimization_tpu_torch.models import descriptor as tdesc
from sift_parallel_optimization_tpu_torch.models.keypoints import keypoints_from_numpy
from sift_parallel_optimization_tpu_torch.ops import patch_gather as tpg
from sift_parallel_optimization_tpu_torch.utils import native as tnative

# Orientation: 1e-3 rad; descriptors: atol 1e-3 -- the tolerance
# tests/test_sift_frontend.py sets between two JAX programs that sum the
# same resample products in another order.
ORI_ATOL = 1e-3
DESC_ATOL = 1e-3


def _origins(rng, k, r, c, rows, cols):
    ys = rng.integers(0, (r - rows) // 8 + 1, size=k).astype(np.int32) * 8
    xs = rng.integers(0, (c - cols) // 128 + 1, size=k).astype(np.int32) * 128
    ys[0], xs[0] = r - rows, c - cols     # last legal row and column
    return ys, xs


def test_patch_gather_matches_jax_slice_and_pallas(rng):
    from jax.experimental.pallas import tpu as pltpu

    r, c, rows, cols = 304, 640, 96, 256
    atlas = rng.normal(size=(r, c)).astype(np.float32)
    ys, xs = _origins(rng, 8, r, c, rows, cols)
    args = (jnp.asarray(atlas), jnp.asarray(ys), jnp.asarray(xs))
    want = np.asarray(jpg.extract_atlas_patches_slice(*args, rows, cols))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jpg.extract_atlas_patches_pallas(*args, rows, cols))
    got = tpg.extract_atlas_patches(
        torch.from_numpy(atlas), torch.from_numpy(ys), torch.from_numpy(xs), rows, cols
    ).numpy()
    # A copy: bitwise equal to both.
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_patch_gather_clamps_like_dynamic_slice(rng):
    atlas = rng.normal(size=(40, 50)).astype(np.float32)
    ys = np.array([-5, 0, 30, 100], np.int32)
    xs = np.array([7, -1, 45, 3], np.int32)
    want = np.asarray(jpg.extract_atlas_patches_slice(
        jnp.asarray(atlas), jnp.asarray(ys), jnp.asarray(xs), 16, 20))
    got = tpg.extract_atlas_patches(
        torch.from_numpy(atlas), torch.from_numpy(ys), torch.from_numpy(xs), 16, 20
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_stage():
    """JAX Gaussian octaves and detector keypoints of a 256^2 frame."""
    size = 256
    cfg = jfe.sift_config(size)
    img = jnp.asarray(tnative.synth_frame(size, 0, seed=0))

    def run(x):
        gauss = jpr.sift_gaussian_pyramid(x, cfg)
        kp = jdet.detect_pyramid([g[1:] - g[:-1] for g in gauss], cfg, 256)
        return gauss, kp

    gauss, kp = jax.jit(run)(img)
    gauss_t = [torch.from_numpy(np.array(g)) for g in gauss]
    kp_t = keypoints_from_numpy({f: np.asarray(v) for f, v in kp._asdict().items()}, "cpu")
    return cfg, gauss, kp, gauss_t, kp_t


def test_build_atlas_matches_jax(jax_stage):
    _cfg, gauss, _kp, gauss_t, _kp_t = jax_stage
    atlas, meta = jax.jit(jdesc.build_atlas)(gauss)
    atlas_t, meta_t = tdesc.build_atlas(gauss_t)
    np.testing.assert_array_equal(atlas_t.numpy(), np.asarray(atlas))
    for k in meta:
        np.testing.assert_array_equal(meta_t[k].numpy(), np.asarray(meta[k]))


def test_keypoint_patches_match_jax(jax_stage):
    cfg, gauss, kp, gauss_t, kp_t = jax_stage
    radius = jdesc.max_patch_radius(cfg.S, cfg.sigma0)
    assert radius == tdesc.max_patch_radius(cfg.S, cfg.sigma0)
    assert tdesc.patch_rows_for(radius) == jdesc.patch_rows_for(radius) == 96
    want = jax.jit(lambda g, k: jdesc._keypoint_patches(g, k, radius))(gauss, kp)
    got = tdesc._keypoint_patches(gauss_t, kp_t, radius)
    for w, g in zip(want, got):  # patches, py, px, sig_o: same ops, bitwise
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dual", [False, True])
def test_orient_and_describe_matches_jax(jax_stage, dual):
    cfg, gauss, kp, gauss_t, kp_t = jax_stage
    radius = jdesc.max_patch_radius(cfg.S, cfg.sigma0)
    kw = dict(dual_orientation=dual, max_radius=radius)
    want_kp, want_d = jax.jit(lambda g, k: jdesc.orient_and_describe(g, k, **kw))(gauss, kp)
    got_kp, got_d = tdesc.orient_and_describe(gauss_t, kp_t, **kw)
    valid = np.asarray(want_kp.valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got_kp.valid.numpy(), valid)
    dtheta = got_kp.orientation.numpy() - np.asarray(want_kp.orientation)
    dtheta = (dtheta + np.pi) % (2 * np.pi) - np.pi    # circular difference
    np.testing.assert_allclose(dtheta, 0.0, atol=ORI_ATOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=DESC_ATOL)
    norms = np.linalg.norm(got_d.numpy(), axis=1)
    np.testing.assert_allclose(norms[valid], 1.0, atol=1e-5)
    assert np.all(norms[~valid] == 0.0)


def test_assign_orientations_and_compute_descriptors_match_jax(jax_stage):
    """The two single-purpose entry points (the default patch radius): the
    dominant orientation within ORI_ATOL of JAX's, then descriptors at
    JAX's orientations within DESC_ATOL, zero rows at invalid slots."""
    _cfg, gauss, kp, gauss_t, kp_t = jax_stage
    want_kp = jax.jit(jdesc.assign_orientations)(gauss, kp)
    got_kp = tdesc.assign_orientations(gauss_t, kp_t)
    valid = np.asarray(want_kp.valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got_kp.valid.numpy(), valid)
    dtheta = got_kp.orientation.numpy() - np.asarray(want_kp.orientation)
    dtheta = (dtheta + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(dtheta, 0.0, atol=ORI_ATOL)
    assert not got_kp.orientation.numpy()[~valid].any()
    oriented = keypoints_from_numpy({f: np.asarray(v) for f, v in want_kp._asdict().items()},
                                    "cpu")
    want_d = np.asarray(jax.jit(jdesc.compute_descriptors)(gauss, want_kp))
    got_d = tdesc.compute_descriptors(gauss_t, oriented).numpy()
    assert got_d.shape == want_d.shape == (valid.shape[0], 128)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=DESC_ATOL)
    assert not got_d[~valid].any()
