"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python3 -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel is held to its plain PyTorch version on the same CUDA tensors.
"""

import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu_torch.core import pyramid_ref
from sift_parallel_optimization_tpu_torch.models import descriptor
from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
from sift_parallel_optimization_tpu_torch.ops import gather_resample as gr
from sift_parallel_optimization_tpu_torch.ops import patch_gather as pg
from sift_parallel_optimization_tpu_torch.ops import scale_space as ss
from sift_parallel_optimization_tpu_torch.ops import score_tables as st
from sift_parallel_optimization_tpu_torch.utils import native

pytestmark = pytest.mark.cuda

# The JAX package's Pallas-vs-jnp tolerance; the kernel avoids FMA
# contraction, so on the card it is in fact bitwise equal to the plain version.
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("size,S", [(512, 2), (1000, 2), (64, 3)])
def test_reference_dog_kernel_matches_plain(dev, size, S):
    img = torch.from_numpy(
        np.random.default_rng(size).random((size, size), dtype=np.float32)
    ).to(dev)
    got = ss.reference_dog_pyramid_cuda(img, S)
    want = ss.reference_dog_pyramid_plain(img, S)
    torch.cuda.synchronize()
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [512, 2048])
def test_patch_gather_kernel_is_bitwise_plain(dev, k):
    rng = np.random.default_rng(k)
    r, c, rows, cols = 7000, 1280, 96, 256
    atlas = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32)).to(dev)
    ys = rng.integers(0, (r - rows) // 8 + 1, size=k).astype(np.int32) * 8
    xs = rng.integers(0, (c - cols) // 128 + 1, size=k).astype(np.int32) * 128
    ys[0], xs[0] = r - rows, c - cols
    xs[1] = 5              # unaligned column: the scalar path
    ys[2], xs[2] = -3, -1  # negative origins count from the end, then clamp
    ys_t, xs_t = torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)
    got = pg.extract_atlas_patches_cuda(atlas, ys_t, xs_t, rows, cols)
    want = pg.extract_atlas_patches_plain(atlas, ys_t, xs_t, rows, cols)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shared", [False, True])
def test_patch_gather_batched_kernel_is_bitwise_plain(dev, shared):
    rng = np.random.default_rng(7)
    b, k, r, c, rows, cols = 4, 300, 3000, 1280, 96, 256
    shape = (r, c) if shared else (b, r, c)
    atlas = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    ys = rng.integers(0, (r - rows) // 8 + 1, size=(b, k)).astype(np.int32) * 8
    xs = rng.integers(0, (c - cols) // 128 + 1, size=(b, k)).astype(np.int32) * 128
    ys[-1, -1], xs[-1, -1] = r - rows, c - cols   # last legal origin of the last frame
    xs[1, 1] = 5                                  # unaligned column: the scalar path
    ys[2, 2], xs[2, 2] = -3, -1                   # negative: from the frame's own end
    ys[1, 3], xs[1, 3] = r + 500, c + 7           # over range: clamps into its own frame
    ys_t, xs_t = torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)
    before = pg.LAUNCHES_BATCHED
    got = pg.extract_atlas_patches_batched(atlas, ys_t, xs_t, rows, cols)
    want = pg.extract_atlas_patches_batched_plain(atlas, ys_t, xs_t, rows, cols)
    torch.cuda.synchronize()
    assert pg.LAUNCHES_BATCHED == before + 1
    assert got.shape == (b, k, rows, cols) and torch.equal(got, want)
    frame1 = atlas if shared else atlas[1]
    assert torch.equal(got[1, 3], frame1[r - rows:, c - cols:])


def test_batched_frontend_launches_each_kernel_once(dev, monkeypatch):
    from sift_parallel_optimization_tpu_torch.parallel.frontend import batched_extract_features

    for name in ("LAUNCHES", "LAUNCHES_BATCHED"):
        monkeypatch.setattr(pg, name, 0)
    monkeypatch.setattr(st, "LAUNCHES", 0)
    imgs = torch.from_numpy(np.stack([native.synth_frame(256, i, seed=0) for i in range(4)]))
    cfg = sift_config(256)
    out = batched_extract_features(imgs, cfg, 64, device=dev)
    torch.cuda.synchronize()
    assert (pg.LAUNCHES, pg.LAUNCHES_BATCHED, st.LAUNCHES) == (0, 1, 1)
    assert out.descriptors.shape == (4, 64, 128) and out.descriptors.is_cuda
    fe = SiftFrontend(cfg, max_keypoints=64, device=dev)
    for i in range(4):
        ref = fe(imgs[i].to(dev))
        assert torch.equal(out.keypoints.valid[i], ref.keypoints.valid)
        assert torch.equal(out.keypoints.octave[i], ref.keypoints.octave)
        torch.testing.assert_close(out.keypoints.x[i], ref.keypoints.x, rtol=0, atol=1e-3)


def _dogs(dev, shape, seed):
    return torch.from_numpy(
        (0.05 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(5, 128, 128), (5, 250, 370), (4, 37, 70)])
def test_score_tables_rows_kernel_is_bitwise_plain(dev, shape):
    dog = _dogs(dev, shape, shape[1])
    got = st.score_tables_rows_cuda(dog, 0.04 / 3, 10.0)
    want = st.score_tables_rows_plain(dog, 0.04 / 3, 10.0)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("refine_iters", [0, 1])
def test_score_block_top2_kernel_is_bitwise_plain(dev, refine_iters):
    # Octaves of a 250 x 370 frame: block tables above 4096 voxels, every
    # voxel below; a ragged last block in each.
    shapes = [(5, 250 >> o, 370 >> o) for o in range(5)]
    flat = torch.cat([_dogs(dev, s, i).reshape(-1) for i, s in enumerate(shapes)])
    got = st.score_block_top2_cuda(flat[None], shapes, 0.04 / 3, 10.0, refine_iters)
    want = st.score_block_top2_plain(flat[None], shapes, 0.04 / 3, 10.0, refine_iters)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int((got[0] > 0).sum()) > 50
    # Three frames in one launch: each frame's tables, indices within the frame.
    batch = torch.stack([flat, flat.flip(0), flat])
    got = st.score_block_top2_cuda(batch, shapes, 0.04 / 3, 10.0, refine_iters)
    want = st.score_block_top2_plain(batch, shapes, 0.04 / 3, 10.0, refine_iters)
    torch.cuda.synchronize()
    assert got[0].shape[0] == 3 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got[1][0], got[1][2])


def test_gather_resample_kernel_matches_plain(dev):
    rng = np.random.default_rng(4)
    k, r, c = 512, 3000, 1280
    atlas = torch.from_numpy(rng.random((r, c), dtype=np.float32)).to(dev)
    grow = rng.integers(0, r - 128, size=k).astype(np.int32)
    x0 = rng.integers(0, c - 256, size=k).astype(np.int32)
    grow[:3], x0[:3] = (r - 128, -5, 7), (c - 256, 3, -1)   # edge and unnormalised origins
    params = np.stack([rng.uniform(-10, 140, k), rng.uniform(-10, 270, k),
                       rng.uniform(1, 60, k), rng.uniform(1, 60, k)], 1).astype(np.float32)
    args = (atlas, torch.from_numpy(grow).to(dev), torch.from_numpy(x0).to(dev),
            torch.from_numpy(params).to(dev))
    got = gr.gather_resample_cuda(*args)
    want = gr.gather_resample_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_wrappers_check_inputs(dev):
    with pytest.raises(ValueError, match="square"):
        ss.reference_dog_pyramid_cuda(torch.zeros(8, 16, device=dev), 2)
    atlas = torch.zeros(64, 64, device=dev)
    idx = torch.zeros(3, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        pg.extract_atlas_patches_cuda(atlas, idx, idx, 8, 8)


def test_main_path_launches_the_kernels(dev, monkeypatch):
    for mod in (ss, pg, st, gr):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    img = torch.from_numpy(native.synth_frame(256, 0, seed=0)).to(dev)
    pyramid_ref.reference_dog_pyramid(img, 2)
    fe = SiftFrontend(sift_config(256), max_keypoints=64, device=dev)
    feats = fe(img)
    monkeypatch.setattr(descriptor, "USE_FUSED_SAMPLING", True)
    fused = fe(img)
    torch.cuda.synchronize()
    assert (ss.LAUNCHES, pg.LAUNCHES, st.LAUNCHES, gr.LAUNCHES) == (1, 1, 2, 1)
    assert int(feats.keypoints.count()) > 0
    assert torch.equal(feats.keypoints.valid, fused.keypoints.valid)
