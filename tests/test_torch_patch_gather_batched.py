"""The port's batched patch gather against the JAX package on the CPU.

A copy: every comparison is bitwise. The references are ``jax.vmap`` of
``extract_atlas_patches_slice`` (per-frame ``lax.dynamic_slice`` semantics)
and the Pallas entry point ``extract_atlas_patches_batched_pallas`` in TPU
interpret mode, as tests/test_torch_descriptor.py runs the 2-D kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.ops import patch_gather as jpg
from sift_parallel_optimization_tpu_torch.ops import patch_gather as tpg

B, R, C, ROWS, COLS = 3, 304, 640, 96, 256


def _slice_batched(atlas, ys, xs, rows, cols):
    axes = (0 if atlas.ndim == 3 else None, 0, 0)
    fn = lambda a, y, x: jpg.extract_atlas_patches_slice(a, y, x, rows, cols)
    return np.asarray(jax.vmap(fn, in_axes=axes)(
        jnp.asarray(atlas), jnp.asarray(ys), jnp.asarray(xs)))


def _aligned_origins(rng, k):
    ys = rng.integers(0, (R - ROWS) // 8 + 1, size=(B, k)).astype(np.int32) * 8
    xs = rng.integers(0, (C - COLS) // 128 + 1, size=(B, k)).astype(np.int32) * 128
    ys[-1, -1], xs[-1, -1] = R - ROWS, C - COLS    # last legal origin of the last frame
    return ys, xs


def _torch(atlas, ys, xs, rows, cols):
    return tpg.extract_atlas_patches_batched(
        torch.from_numpy(atlas), torch.from_numpy(ys), torch.from_numpy(xs), rows, cols
    ).numpy()


def test_batched_gather_matches_jax_slice_and_pallas(rng):
    from jax.experimental.pallas import tpu as pltpu

    atlas = rng.normal(size=(B, R, C)).astype(np.float32)
    ys, xs = _aligned_origins(rng, 6)
    got = _torch(atlas, ys, xs, ROWS, COLS)
    assert got.shape == (B, 6, ROWS, COLS)
    np.testing.assert_array_equal(got, _slice_batched(atlas, ys, xs, ROWS, COLS))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jpg.extract_atlas_patches_batched_pallas(
            jnp.asarray(atlas), jnp.asarray(ys), jnp.asarray(xs), ROWS, COLS))
    np.testing.assert_array_equal(got, pallas)
    # ... and each frame equals the 2-D entry point on that frame.
    for b in range(B):
        one = tpg.extract_atlas_patches(torch.from_numpy(atlas[b]), torch.from_numpy(ys[b]),
                                        torch.from_numpy(xs[b]), ROWS, COLS).numpy()
        np.testing.assert_array_equal(got[b], one)


def test_batched_gather_shared_atlas_matches_jax(rng):
    from jax.experimental.pallas import tpu as pltpu

    atlas = rng.normal(size=(R, C)).astype(np.float32)
    ys, xs = _aligned_origins(rng, 5)
    got = _torch(atlas, ys, xs, ROWS, COLS)
    np.testing.assert_array_equal(got, _slice_batched(atlas, ys, xs, ROWS, COLS))
    # The custom_vmap rule's shared-atlas branch: the batch folded into K.
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jpg.extract_atlas_patches_pallas(
            jnp.asarray(atlas), jnp.asarray(ys.reshape(-1)), jnp.asarray(xs.reshape(-1)),
            ROWS, COLS)).reshape(B, 5, ROWS, COLS)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("shared", [False, True])
def test_batched_gather_clamps_per_frame_like_dynamic_slice(rng, shared):
    """Negative origins wrap by the frame's own R / C and every origin clamps
    into its own frame: never into the rows of a neighbouring frame, where
    an atlas folded to (B*R, C) would put an over-range origin."""
    r, c, rows, cols = 40, 50, 16, 20
    atlas = rng.normal(size=(r, c) if shared else (3, r, c)).astype(np.float32)
    ys = np.array([[-5, 0, 30, 100], [39, -41, 24, -1], [25, 7, -100, 1000]], np.int32)
    xs = np.array([[7, -1, 45, 3], [-50, 31, 30, 49], [0, -7, 500, -500]], np.int32)
    got = _torch(atlas, ys, xs, rows, cols)
    np.testing.assert_array_equal(got, _slice_batched(atlas, ys, xs, rows, cols))
    frame1 = atlas if shared else atlas[1]
    np.testing.assert_array_equal(got[1, 0], frame1[r - rows:, :cols])   # (39, -50) clamps


def test_batched_gather_checks_its_inputs():
    atlas = torch.zeros(2, 32, 32)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(B, K\) origins"):
        tpg.extract_atlas_patches_batched(atlas, idx[0], idx[0], 8, 8)
    with pytest.raises(ValueError, match=r"\(B, K\) origins"):
        tpg.extract_atlas_patches_batched(torch.zeros(3, 32, 32), idx, idx, 8, 8)
    with pytest.raises(ValueError, match="does not fit"):
        tpg.extract_atlas_patches_batched(atlas, idx, idx, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tpg.extract_atlas_patches_batched_cuda(atlas, idx, idx, 8, 8)
    meta = torch.empty((2, 32, 32), device="meta")
    midx = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpg.extract_atlas_patches_batched(meta, midx, midx, 8, 8)
    empty = tpg.extract_atlas_patches_batched(atlas, idx[:, :0], idx[:, :0], 8, 8)
    assert empty.shape == (2, 0, 8, 8)
