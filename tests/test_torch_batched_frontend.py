"""The port's batched frontend on the CPU: batched detection against the
port's per-frame detection (bitwise) and the JAX package's batched detector,
the batched pyramid and describe stage against their per-frame forms, and
``batched_extract_features`` against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import detect as jdet
from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu.parallel import frontend as jpf
from sift_parallel_optimization_tpu_torch.core import pyramid_ref as tpr
from sift_parallel_optimization_tpu_torch.models import descriptor as tdesc
from sift_parallel_optimization_tpu_torch.models import detect as tdet
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models.keypoints import Keypoints
from sift_parallel_optimization_tpu_torch.ops import patch_gather as tpg
from sift_parallel_optimization_tpu_torch.parallel import frontend as tpf

SIZE, K = 96, 128
# Keypoints, port against JAX: tests/test_torch_detect.py's tolerance.
COORD_ATOL = 1e-4
# Batched against per-frame programs: the tolerances that
# tests/test_sift_frontend.py sets between two such JAX programs (the batched
# matrix products reassociate float adds).
BATCH_ATOL, ORI_ATOL, DESC_ATOL = 1e-3, 1e-3, 5e-3


def _frames(b, size, seed=100):
    """tests/test_sift_frontend.py's blob frames with tests/test_matching.py's
    texture (40 blobs under band-limited noise): ~20 keypoints a frame."""
    out = []
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(b):
        rng = np.random.default_rng(seed + i)
        img = np.full((size, size), 0.5, np.float32)
        for _ in range(40):
            cy, cx = rng.uniform(8, size - 8, 2)
            s = rng.uniform(1.5, 6.0)
            img += rng.uniform(-0.4, 0.4) * np.exp(
                -((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
        noise = np.pad(rng.random((size, size), np.float32), 1, mode="edge")
        box = sum(noise[dy:dy + size, dx:dx + size] for dy in range(3) for dx in range(3)) / 9
        img += 0.3 * (box - box.mean())
        out.append(img.astype(np.float32))
    return np.stack(out)


@pytest.fixture(scope="module")
def frames():
    return _frames(3, SIZE)


@pytest.fixture(scope="module")
def dogs(frames):
    """Per-frame DoG octaves from the port's per-frame pyramid."""
    cfg = tfe.sift_config(SIZE)
    return [tpr.sift_dog_pyramid(torch.from_numpy(f), cfg) for f in frames]


def _frame(kp, i):
    return Keypoints(*[f[i] for f in kp])


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("refine", [0, 1])
def test_batched_detect_equals_per_frame_bitwise(dogs, refine, approx):
    cfg = tfe.sift_config(SIZE)
    dogs_b = [torch.stack([d[o] for d in dogs]) for o in range(len(dogs[0]))]
    kw = dict(refine_iters=refine, use_approx_topk=approx)
    batched = tdet.detect_pyramid_batched(dogs_b, cfg, K, **kw)
    assert batched.x.shape == (3, K)
    for i, d in enumerate(dogs):
        single = tdet.detect_pyramid(d, cfg, K, **kw)
        assert int(single.count()) > 5
        for f, a, b in zip(Keypoints._fields, _frame(batched, i), single):
            assert torch.equal(a, b), (i, f)
    # A frame's keypoints do not depend on the batch it is in.
    pair = tdet.detect_pyramid_batched([d[1:] for d in dogs_b], cfg, K, **kw)
    for a, b in zip(_frame(pair, 0), _frame(batched, 1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("refine", [0, 1])
def test_batched_detect_matches_jax_batched(dogs, refine):
    jcfg = jfe.sift_config(SIZE)
    dogs_b = [torch.stack([d[o] for d in dogs]) for o in range(len(dogs[0]))]
    want = jax.jit(lambda d: jdet.detect_pyramid_batched(d, jcfg, K, refine_iters=refine))(
        [jnp.asarray(d.numpy()) for d in dogs_b])
    got = tdet.detect_pyramid_batched(dogs_b, tfe.sift_config(SIZE), K, refine_iters=refine)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for f in ("octave", "scale"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                      np.asarray(getattr(want, f))[valid], err_msg=f)
    for f in ("x", "y", "sigma", "score"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=COORD_ATOL, err_msg=f)


def test_batched_detect_checks_its_input(dogs):
    with pytest.raises(ValueError, match=r"\(B, S\+2, H_o, W_o\)"):
        tdet.detect_pyramid_batched(dogs[0], tfe.sift_config(SIZE), K)


def test_batched_pyramid_matches_per_frame(frames):
    cfg = tfe.sift_config(SIZE)
    pyr = tpr.SiftPyramid(cfg, SIZE)
    batched = pyr(torch.from_numpy(frames))
    for i, f in enumerate(frames):
        single = pyr(torch.from_numpy(f))
        assert len(single) == len(batched)
        for b, s in zip(batched, single):
            assert b.shape == (3, *s.shape)
            # One product summed in another order: a few ulp of values in [0, 1].
            torch.testing.assert_close(b[i], s, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="expected"):
        pyr(torch.zeros(2, SIZE, SIZE + 1))


@pytest.mark.parametrize("dual", [False, True])
def test_batched_describe_equals_per_frame_and_gathers_once(dogs, frames, dual, monkeypatch):
    """On the SAME Gaussian octaves the batched describe stage is the
    per-frame one with the frames folded: one batched gather, equal results."""
    cfg = tfe.sift_config(SIZE)
    pyr = tpr.SiftPyramid(cfg, SIZE)
    gauss = [pyr(torch.from_numpy(f)) for f in frames]
    gauss_b = [torch.stack([g[o] for g in gauss]) for o in range(len(gauss[0]))]
    dogs_b = [g[:, 1:] - g[:, :-1] for g in gauss_b]
    kp_b = tdet.detect_pyramid_batched(dogs_b, cfg, K)
    calls = []
    real = tpg.extract_atlas_patches_batched
    monkeypatch.setattr(tdesc, "extract_atlas_patches_batched",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    radius = tdesc.max_patch_radius(cfg.S, cfg.sigma0)
    kp_out, desc = tdesc.orient_and_describe(gauss_b, kp_b, dual_orientation=dual,
                                             max_radius=radius)
    assert calls == [(3, K)]
    n = 2 * K if dual else K
    assert desc.shape == (3, n, 128) and kp_out.x.shape == (3, n)
    for i in range(3):
        kp_i, desc_i = tdesc.orient_and_describe(gauss[i], _frame(kp_b, i),
                                                 dual_orientation=dual, max_radius=radius)
        for f, a, b in zip(Keypoints._fields, _frame(kp_out, i), kp_i):
            # Batched bmm of the same operands: same kernel per item on the CPU.
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=f)
        torch.testing.assert_close(desc[i], desc_i, rtol=0, atol=1e-6)


def test_batched_atlas_equals_per_frame_and_caches_its_tables(frames):
    cfg = tfe.sift_config(SIZE)
    gauss_b = tpr.SiftPyramid(cfg, SIZE)(torch.from_numpy(frames))
    atlas_b, meta_b = tdesc.build_atlas(gauss_b)
    assert atlas_b.dim() == 3 and atlas_b.is_contiguous()
    for i in range(3):
        atlas, meta = tdesc.build_atlas([g[i] for g in gauss_b])
        assert torch.equal(atlas_b[i], atlas)
        # Built once per (shapes, device): the same tensors every call.
        assert all(meta[k] is meta_b[k] for k in ("row_off", "hprime", "wlim"))


@pytest.fixture(scope="module")
def jax_features(frames):
    """The JAX package's batched frontend on the three frames, compiled once.
    It unrolls detection and description per frame, so its first two frames
    are also its answer for a batch of two."""
    jcfg = jfe.sift_config(SIZE)
    return jax.jit(lambda x: jpf.batched_extract_features(x, jcfg, max_keypoints=64))(
        jnp.asarray(frames))


@pytest.mark.parametrize("b", [2, 3])
def test_batched_extract_features_matches_jax(frames, jax_features, b):
    want = jax.tree.map(lambda a: a[:b], jax_features)
    got = tpf.batched_extract_features(torch.from_numpy(frames[:b]), tfe.sift_config(SIZE),
                                       max_keypoints=64)
    assert got.descriptors.shape == (b, 64, 128)
    valid = np.asarray(want.keypoints.valid)
    assert valid.sum() > 10 * b
    np.testing.assert_array_equal(got.keypoints.valid.numpy(), valid)
    for f in Keypoints._fields:
        if f in ("orientation", "valid"):
            continue
        # rtol: a coarse octave's subpixel offset is scaled by 2^octave, and
        # a flat Hessian amplifies the pyramids' ~3e-7 difference (seen: 1.3e-3
        # px on a keypoint of octave 2).
        np.testing.assert_allclose(getattr(got.keypoints, f).numpy(),
                                   np.asarray(getattr(want.keypoints, f)),
                                   rtol=1e-4, atol=BATCH_ATOL, err_msg=f)
    dori = np.abs(got.keypoints.orientation.numpy() - np.asarray(want.keypoints.orientation))
    dori = np.minimum(dori, 2 * np.pi - dori)
    close = dori < ORI_ATOL
    # tests/test_sift_frontend.py's gate between two JAX programs: exact for
    # >= 90% of slots, a consistent descriptor for the rest.
    assert close.mean() >= 0.90, f"orientation flips: {(~close).sum()}"
    ddesc = np.abs(got.descriptors.numpy() - np.asarray(want.descriptors)).max(-1)
    assert (ddesc[close] < DESC_ATOL).all(), ddesc[close].max()
    norms = np.linalg.norm(got.descriptors.numpy(), axis=-1)
    np.testing.assert_allclose(norms[valid], 1.0, atol=1e-5)
    assert (norms[~valid] == 0).all()


@pytest.mark.parametrize("kw", [{}, {"dual_orientation": True}, {"use_approx_topk": True},
                                {"refine_iters": 0}])
def test_batched_extract_features_matches_per_frame_frontend(frames, kw):
    cfg = tfe.sift_config(SIZE)
    imgs = torch.from_numpy(frames)
    fe = tfe.SiftFrontend(cfg, max_keypoints=64, device="cpu", **kw)
    out = tpf.batched_extract_features(imgs, cfg, 64, **kw)
    via_module = fe(imgs)
    for a, b in zip((*out.keypoints, out.descriptors),
                    (*via_module.keypoints, via_module.descriptors)):
        assert torch.equal(a, b)
    for i in range(3):
        ref = fe(imgs[i])
        for f in ("octave", "scale", "valid"):
            assert torch.equal(getattr(out.keypoints, f)[i], getattr(ref.keypoints, f)), f
        for f in ("x", "y", "sigma", "score"):
            torch.testing.assert_close(getattr(out.keypoints, f)[i], getattr(ref.keypoints, f),
                                       rtol=0, atol=BATCH_ATOL, msg=f)
        dori = (out.keypoints.orientation[i] - ref.keypoints.orientation).abs()
        close = torch.minimum(dori, 2 * np.pi - dori) < ORI_ATOL
        assert float(close.float().mean()) >= 0.90
        ddesc = (out.descriptors[i] - ref.descriptors).abs().amax(-1)
        assert bool((ddesc[close] < DESC_ATOL).all())


def test_batched_extract_features_fused_branch_runs_per_frame(frames, monkeypatch):
    cfg = tfe.sift_config(SIZE)
    imgs = torch.from_numpy(frames[:2])
    monkeypatch.setattr(tdesc, "USE_FUSED_SAMPLING", True)
    out = tpf.batched_extract_features(imgs, cfg, 64)
    for i in range(2):
        ref = tfe.extract_features(imgs[i], cfg, 64)
        assert torch.equal(out.keypoints.valid[i], ref.keypoints.valid)
        torch.testing.assert_close(out.descriptors[i], ref.descriptors, rtol=0, atol=DESC_ATOL)
