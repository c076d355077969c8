"""Kernel 4 (the fused gather-resample) and the port's USE_FUSED_SAMPLING
descriptor branch against the JAX package on CPU.

The port's plain version runs here; the CUDA kernel is held to it on the card
(tests/test_torch_cuda.py, chip_smoke.py). The JAX Pallas kernel runs in
interpret mode, as tests/test_descriptor_fused.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sift_parallel_optimization_tpu.models import descriptor as jdesc
from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu.ops.descriptor_fused import gather_resample_pallas
from sift_parallel_optimization_tpu_torch.models import descriptor as tdesc
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.ops import gather_resample as tgr
from sift_parallel_optimization_tpu_torch.utils import native as tnative

# tests/test_descriptor_fused.py's tolerance: the sums run in another order.
ATOL = RTOL = 1e-5


def _inputs(rng, k=8):
    """tests/test_descriptor_fused.py's inputs."""
    pr, pc = jdesc.PATCH_ROWS, jdesc.PATCH_COLS
    atlas = rng.random((512, 640), np.float32)
    grow = (rng.integers(0, (512 - pr) // 16, k) * 16).astype(np.int32)
    x0 = (rng.integers(0, (640 - pc) // 128, k) * 128).astype(np.int32)
    params = np.zeros((k, 128), np.float32)
    params[:, 0] = 40.0 + 30.0 * rng.random(k)
    params[:, 1] = 100.0 + 50.0 * rng.random(k)
    params[:, 2] = 5.0 + 30.0 * rng.random(k)
    params[:, 3] = 5.0 + 40.0 * rng.random(k)
    return atlas, grow, x0, params


def _both(atlas, grow, x0, params):
    want = gather_resample_pallas(*(jnp.asarray(a) for a in (atlas, grow, x0, params)),
                                  interpret=True)
    got = tgr.gather_resample(*(torch.from_numpy(a) for a in (atlas, grow, x0, params)))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _float64_reference(atlas, grow, x0, params):
    """The same sampling in float64 from the f32 sample coordinates."""
    outs = []
    for g, col in ((tgr.ORI_GRID, 2), (tgr.DESC_GRID, 3)):
        lin = np.arange(g, dtype=np.float32) * np.float32(2.0 / (g - 1)) - np.float32(1.0)
        res = []
        for k in range(len(grow)):
            patch = atlas[grow[k]:grow[k] + tgr.PATCH_ROWS, x0[k]:x0[k] + tgr.PATCH_COLS]
            cy = (params[k, 0] + lin * params[k, col]).astype(np.float64)
            cx = (params[k, 1] + lin * params[k, col]).astype(np.float64)
            ay = np.maximum(0.0, 1.0 - np.abs(cy[:, None] - np.arange(tgr.PATCH_ROWS)))
            ax = np.maximum(0.0, 1.0 - np.abs(cx[:, None] - np.arange(tgr.PATCH_COLS)))
            res.append(ay @ patch.astype(np.float64) @ ax.T)
        outs.append(np.stack(res))
    return outs


def test_gather_resample_matches_pallas(rng):
    inputs = _inputs(rng)
    want, got = _both(*inputs)
    for g, w, r, n in zip(got, want, _float64_reference(*inputs), (tgr.ORI_GRID, tgr.DESC_GRID)):
        assert g.shape == w.shape == (8, n, n)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
        # Two non-zero taps per axis, each product and sum rounded once.
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-6)
    assert float(np.abs(got[1]).max()) > 0.1


def test_off_patch_samples_are_zero(rng):
    atlas = rng.random((256, 512), np.float32)
    params = np.zeros((1, 128), np.float32)
    params[0, :4] = (4.0, 4.0, 200.0, 300.0)
    zero = np.zeros(1, np.int32)
    want, got = _both(atlas, zero, zero, params)
    for g, w, r in zip(got, want, _float64_reference(atlas, zero, zero, params)):
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(g == 0, w == 0)
        # At radius 300 the interpret run of the Pallas kernel itself lies up
        # to 1.4e-5 from the float64 value at a sample whose taps weigh
        # 2e-5 / 1 - 2e-5 (the port lies within 1e-6 of it, above).
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=RTOL)
    # Far-out rows and columns of the grids are exactly zero.
    assert float(np.abs(got[0][0, 0]).max()) == 0.0
    assert float(np.abs(got[1][0, -1]).max()) == 0.0
    assert float(np.abs(got[1][0, :, -1]).max()) == 0.0


def test_plain_version_takes_four_param_columns(rng):
    atlas, grow, x0, params = _inputs(rng, k=4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    wide = tgr.gather_resample(t(atlas), t(grow), t(x0), t(params))
    narrow = tgr.gather_resample(t(atlas), t(grow), t(x0), t(params[:, :4]))
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)


def test_fused_sampling_frontend_matches_jax(monkeypatch):
    """The port's frontend with USE_FUSED_SAMPLING against the JAX frontend's
    default branch (its fused branch runs only on a TPU)."""
    size, k = 256, 256
    # The keypoint floor below assumes the native frame, not the NumPy
    # fallback: a toolchain that cannot build the library fails here.
    assert tnative._load() is not None, tnative._build_error
    frame = tnative.synth_frame(size, 0, seed=0)
    want = jax.jit(lambda x: jfe.extract_features(x, jfe.sift_config(size), k))(
        jnp.asarray(frame))
    monkeypatch.setattr(tdesc, "USE_FUSED_SAMPLING", True)
    calls = []
    monkeypatch.setattr(tdesc, "gather_resample",
                        lambda *a: calls.append(a) or tgr.gather_resample(*a))
    got = tfe.extract_features(torch.from_numpy(frame.copy()), tfe.sift_config(size), k)
    assert len(calls) == 1 and calls[0][3].shape == (k, 4)
    wk, gk = want.keypoints, got.keypoints
    valid = np.asarray(wk.valid)
    assert valid.sum() > 40
    # Keypoints: detection is the same code on the same pyramid.
    np.testing.assert_array_equal(gk.valid.numpy(), valid)
    for f in ("x", "y", "sigma"):
        np.testing.assert_allclose(getattr(gk, f).numpy(), np.asarray(getattr(wk, f)),
                                   rtol=0, atol=1e-4, err_msg=f)
    # Descriptors: the fused branch samples at the Pallas iota coordinates,
    # which round unlike linspace; that moves a near-tied orientation peak
    # now and then, which rotates its whole descriptor. So >= 99% (not all)
    # of the descriptors lie within L2 1e-3 of JAX's.
    d = np.linalg.norm(got.descriptors.numpy()[valid] - np.asarray(want.descriptors)[valid],
                       axis=1)
    assert (d <= 1e-3).mean() >= 0.99, np.sort(d)[-5:]
    assert not got.descriptors.numpy()[~valid].any()
