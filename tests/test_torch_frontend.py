"""The port's whole SIFT frontend against the JAX package, end to end, and
the port's CLI on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu_torch import cli as tcli
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.utils import native as tnative

SIZE, K = 256, 256
# Coordinates: the pyramids run the same products (the composite tail
# included) and agree to f32 summation order, and detection runs the same
# expressions, so 1e-4 px. Orientation
# and descriptors: 1e-3, the batched-vs-serial tolerance that
# tests/test_sift_frontend.py sets between two JAX programs.
COORD_ATOL = 1e-4
ORI_ATOL = 1e-3
DESC_ATOL = 1e-3


@pytest.fixture(scope="module")
def frame():
    # The keypoint floors below assume the native frame, not the NumPy
    # fallback: a toolchain that cannot build the library fails here.
    assert tnative._load() is not None, tnative._build_error
    return tnative.synth_frame(SIZE, 0, seed=0)


@pytest.fixture(scope="module")
def jax_dual(frame):
    """The JAX frontend with dual orientation; its first K slots are the
    single-orientation output (orient_and_describe puts them first)."""
    jcfg = jfe.sift_config(SIZE)
    return jax.jit(
        lambda x: jfe.extract_features(x, jcfg, K, dual_orientation=True)
    )(jnp.asarray(frame))


@pytest.mark.parametrize("dual", [False, True])
def test_frontend_matches_jax(frame, jax_dual, dual):
    n = 2 * K if dual else K
    want = jfe.Features(
        keypoints=type(jax_dual.keypoints)(*[f[:n] for f in jax_dual.keypoints]),
        descriptors=jax_dual.descriptors[:n],
    )
    got = tfe.extract_features(
        torch.from_numpy(frame.copy()), tfe.sift_config(SIZE), K, dual_orientation=dual
    )
    wk, gk = want.keypoints, got.keypoints
    assert gk.capacity == (2 * K if dual else K)
    valid = np.asarray(wk.valid)
    assert valid.sum() > 40
    np.testing.assert_array_equal(gk.valid.numpy(), valid)
    for f in ("octave", "scale"):
        np.testing.assert_array_equal(
            getattr(gk, f).numpy()[valid], np.asarray(getattr(wk, f))[valid]
        )
    for f in ("x", "y", "sigma"):
        np.testing.assert_allclose(getattr(gk, f).numpy(), np.asarray(getattr(wk, f)),
                                   rtol=0, atol=COORD_ATOL, err_msg=f)
    dtheta = gk.orientation.numpy() - np.asarray(wk.orientation)
    dtheta = (dtheta + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(dtheta, 0.0, atol=ORI_ATOL)
    np.testing.assert_allclose(got.descriptors.numpy(), np.asarray(want.descriptors),
                               rtol=0, atol=DESC_ATOL)


def test_frontend_module_reuses_buffers(frame):
    cfg = tfe.sift_config(SIZE)
    fe = tfe.SiftFrontend(cfg, SIZE, SIZE, max_keypoints=K, device="cpu")
    assert all(b.device.type == "cpu" for b in fe.buffers())
    img = torch.from_numpy(frame.copy())
    a, b = fe(img), fe(img)
    c = tfe.extract_features(img, cfg, K)
    for u, v, w in zip((*a.keypoints, a.descriptors), (*b.keypoints, b.descriptors),
                       (*c.keypoints, c.descriptors)):
        assert torch.equal(u, v) and torch.equal(u, w)


def test_frontend_rectangular():
    img = tnative.synth_frame(160, 1, seed=3)[:96, :160].copy()
    out = tfe.extract_features(torch.from_numpy(img), tfe.sift_config(96), 64)
    norms = torch.linalg.vector_norm(out.descriptors, dim=1)
    v = out.keypoints.valid
    assert int(v.sum()) > 0
    torch.testing.assert_close(norms[v], torch.ones_like(norms[v]), rtol=0, atol=1e-5)
    assert bool((norms[~v] == 0).all())
    assert float(out.keypoints.x[v].max()) < 160 and float(out.keypoints.y[v].max()) < 96


def test_cli_features_and_pyramid_on_cpu(capsys, tmp_path):
    assert tcli.main(["features", "--size", "128", "--device", "cpu"]) == 0
    assert "keypoints (capacity 512)" in capsys.readouterr().out
    assert tcli.main(["pyramid", "--size", "64", "--device", "cpu",
                      "--dump-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("octave ") == 7 and "shape=(5, 64, 64)" in out
    assert (tmp_path / "octave6.pgm").exists()
    assert tcli.main(["pyramid", "--size", "64", "--mode", "sift", "--S", "3",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("octave ") == 4 and "shape=(5, 64, 64)" in out


def test_cli_refuses_cuda_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["features", "--size", "64", "--device", "cuda"])
