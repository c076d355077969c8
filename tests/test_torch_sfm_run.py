"""The port's incremental SfM driver against the JAX package on the CPU:
``register_frame`` and ``run_sfm`` (7 frames out and back, so loops close)
with the JAX key chain's RANSAC draws injected, the covisibility order,
checkpoint resume and its fingerprint, and ``cli sfm --device cpu``.

The features are synthetic (``utils/synthetic``: tests/test_sfm.py's
construction), so matching, PnP, triangulation, BA, loop closure and PGO are
tested apart from the image frontend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import ba as jba
from sift_parallel_optimization_tpu.models import matching as jm
from sift_parallel_optimization_tpu.models import sfm as jsfm
from sift_parallel_optimization_tpu.models.frontend import Features as JFeatures
from sift_parallel_optimization_tpu.models.keypoints import Keypoints as JKeypoints
from sift_parallel_optimization_tpu.parallel import matching as jpm
from sift_parallel_optimization_tpu.utils import trajectory as jtraj
from sift_parallel_optimization_tpu_torch import cli as tcli
from sift_parallel_optimization_tpu_torch.models import ba as tba
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models import sfm as tsfm
from sift_parallel_optimization_tpu_torch.parallel import matching as tpm
from sift_parallel_optimization_tpu_torch.utils import checkpoint as tckpt
from sift_parallel_optimization_tpu_torch.utils import synthetic
from sift_parallel_optimization_tpu_torch.utils import trajectory as ttraj

K_NP = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)
K_J, K_T = jnp.asarray(K_NP), torch.from_numpy(K_NP)
N_FRAMES, B, N_PTS, CAPACITY = 7, 64, 200, 256
RUN_KW = dict(pts_per_frame=B, loop_min_gap=2, loop_min_inliers=20)
# Poses of the whole run: every registration's PnP and every BA agree to
# ~1e-4 between the packages, and the chain adds them up; translations to
# 5e-3 of the largest (the scale is the bootstrap pair's unit baseline),
# rotations to 1e-3 rad.
RUN_T_RTOL, RUN_R_ATOL = 5e-3, 1e-3
# Landmark slots: a point at an inlier threshold's margin can fall on the
# other side in one package (one or two a registration) and shift the rest
# of its block, so slots are compared as counts (within 3%) and point sets
# (97% of JAX's landmarks within 1e-2 of a port landmark).
COUNT_RTOL, SET_FRAC, SET_ATOL = 0.03, 0.97, 1e-2


def _jax_features(arrays):
    return JFeatures(JKeypoints(**{k: jnp.asarray(v) for k, v in arrays["keypoints"].items()}),
                     jnp.asarray(arrays["descriptors"]))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    pts, descs = synthetic.landmarks(rng, N_PTS)
    rv, tv = synthetic.out_and_back(N_FRAMES)
    feats = [synthetic.view_features(rng, pts, descs, rv[i], tv[i], K_NP, 400, 300, CAPACITY)
             for i in range(N_FRAMES)]
    return feats, (rv, tv)


_DRAW = jax.jit(jm._sample_indices, static_argnums=(2, 3))


def jax_sampler(key, n):
    """``run_sfm``'s sampler giving the JAX driver's draws: one key per frame
    (``random.split(key, n)``), split again for registration PnP, and the
    loop keys from ``fold_in(key, 7)``."""
    keys = jax.random.split(key, n)
    loop_keys = jax.random.split(jax.random.fold_in(key, 7), n)

    def sample(kind, frame, valid, n_hyp, n_pts):
        k = {"init": lambda: keys[0], "pnp": lambda: jax.random.split(keys[frame])[0],
             "loop": lambda: loop_keys[frame]}[kind]()
        return np.array(_DRAW(k, jnp.asarray(valid.cpu().numpy()), n_hyp, n_pts))

    return sample


def _assert_point_sets_close(got_pts, want_pts):
    d = np.linalg.norm(want_pts[:, None, :] - got_pts[None, :, :], axis=-1).min(axis=1)
    assert (d < SET_ATOL * np.abs(want_pts).max()).mean() >= SET_FRAC, np.sort(d)[-5:]


def _loops_written(obs_valid, n):
    return int(np.asarray(obs_valid)[3 * n * B:].reshape(-1, B).any(-1).sum())


def test_register_frame_matches_jax_with_injected_draws(scene):
    feats, _poses = scene
    jf = [_jax_features(f) for f in feats[:3]]
    tf = [tfe.features_from_numpy(f, "cpu") for f in feats[:3]]
    key0, key2 = jax.random.key(0), jax.random.key(2)
    jmap, jused = jax.jit(lambda k, a, b: jsfm.init_two_view(
        k, a, b, K_J, jsfm.empty_map(N_FRAMES, B), B))(key0, jf[0], jf[1])
    want, want_used = jax.jit(lambda k, m, a, b, u: jsfm.register_frame(
        k, m, a, b, 2, K_J, u, B))(key2, jmap, jf[2], jf[1], jused)
    # The same bootstrap on both sides; the PnP draws of JAX's split key.
    tmap = tsfm.sfm_map_from_numpy(jmap, "cpu")
    k_pnp = jax.random.split(key2)[0]
    draws = lambda valid, n, k: np.array(_DRAW(k_pnp, jnp.asarray(valid.numpy()), n, k))
    got, used = tsfm.register_frame(None, tmap, tf[2], tf[1], 2, K_T,
                                    torch.from_numpy(np.asarray(jused)), B, sample_idx=draws)
    np.testing.assert_array_equal(got.cam_valid.numpy(), np.asarray(want.cam_valid))
    np.testing.assert_allclose(got.rvecs.numpy(), np.asarray(want.rvecs), atol=1e-3)
    np.testing.assert_allclose(got.tvecs.numpy(), np.asarray(want.tvecs), atol=1e-3)
    n_got, n_want = int(got.pt_valid.sum()), int(want.pt_valid.sum())
    assert abs(n_got - n_want) <= max(1, COUNT_RTOL * n_want) and n_got > 20
    v, jv = got.pt_valid.numpy(), np.asarray(want.pt_valid)
    _assert_point_sets_close(got.points.numpy()[v], np.asarray(want.points)[jv])
    # The PnP block: the same landmarks observed, in the same slots but for
    # those at an inlier margin.
    blk = slice(3 * 2 * B, 3 * 2 * B + B)
    gv, wv = got.obs.valid.numpy()[blk], np.asarray(want.obs.valid)[blk]
    assert abs(int(gv.sum()) - int(wv.sum())) <= 1
    observed = set(got.obs.pt_idx.numpy()[blk][gv])
    assert len(observed ^ set(np.asarray(want.obs.pt_idx)[blk][wv])) <= 2
    assert (used.numpy() != np.asarray(want_used)).sum() <= 3
    # Pure: the map handed in is untouched.
    assert not bool(tmap.cam_valid[2]) and not bool(tmap.obs.valid[blk].any())


@pytest.fixture(scope="module")
def runs(scene):
    """The JAX run and the port's with the JAX draws injected."""
    feats, _poses = scene
    key = jax.random.key(0)
    want = jsfm.run_sfm(key, [_jax_features(f) for f in feats], K_J, **RUN_KW)
    got = tsfm.run_sfm(None, [tfe.features_from_numpy(f, "cpu") for f in feats], K_T,
                       sampler=jax_sampler(key, N_FRAMES), **RUN_KW)
    return want, got


def test_run_sfm_matches_jax_and_closes_loops(scene, runs):
    want, got = runs
    (rv, tv) = scene[1]
    np.testing.assert_array_equal(got.cam_valid.numpy(), np.ones(N_FRAMES, bool))
    np.testing.assert_array_equal(got.cam_valid.numpy(), np.asarray(want.cam_valid))
    loops = _loops_written(got.obs.valid, N_FRAMES)
    assert loops >= 1 and loops == _loops_written(want.obs.valid, N_FRAMES)
    np.testing.assert_allclose(got.rvecs.numpy(), np.asarray(want.rvecs), atol=RUN_R_ATOL)
    np.testing.assert_allclose(got.tvecs.numpy(), np.asarray(want.tvecs),
                               atol=RUN_T_RTOL * np.abs(np.asarray(want.tvecs)).max())
    n_got, n_want = int(got.pt_valid.sum()), int(want.pt_valid.sum())
    assert abs(n_got - n_want) <= COUNT_RTOL * n_want
    v, jv = got.pt_valid.numpy(), np.asarray(want.pt_valid)
    _assert_point_sets_close(got.points.numpy()[v], np.asarray(want.points)[jv])
    # Reprojection RMS under a pixel, and within 2% of JAX's (over landmark
    # sets that differ by up to 3%).
    e_got = float(tba.rms_error(got.ba_state(), got.obs, K_T))
    e_want = float(jba.rms_error(want.ba_state(), want.obs, K_J))
    assert e_got < 1.0 and abs(e_got - e_want) <= 0.02 * e_want
    # ATE after Sim(3) alignment: within the 2% gate, and equal to JAX's to 1e-3.
    gt = ttraj.camera_centers(torch.from_numpy(rv), torch.from_numpy(tv))
    ate = float(ttraj.ate_rmse(ttraj.camera_centers(got.rvecs, got.tvecs), gt))
    span = float(np.linalg.norm(np.ptp(gt.numpy(), axis=0)))
    want_ate = float(jtraj.ate_rmse(jtraj.camera_centers(want.rvecs, want.tvecs),
                                    jnp.asarray(gt.numpy())))
    assert ate <= 0.02 * span and abs(ate - want_ate) < 1e-3


def test_covisibility_order_matches_jax(scene):
    feats, (rv, tv) = scene
    perm = [3, 0, 5, 1, 6, 2, 4]                  # a shuffled capture
    shuffled = [feats[i] for i in perm]
    desc = np.stack([f["descriptors"] for f in shuffled])
    val = np.stack([f["keypoints"]["valid"] for f in shuffled])
    want = np.asarray(jax.jit(jpm.pairwise_match_counts)(jnp.asarray(desc), jnp.asarray(val)))
    got = tpm.pairwise_match_counts(torch.from_numpy(desc), torch.from_numpy(val)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tpm.covisibility_order(got) == jpm.covisibility_order(want)
    m = tsfm.run_sfm(torch.Generator().manual_seed(0),
                     [tfe.features_from_numpy(f, "cpu") for f in shuffled], K_T,
                     pair_selection="covisibility", loop_closure=False, **RUN_KW)
    assert int(m.cam_valid.sum()) == N_FRAMES
    assert float(tba.rms_error(m.ba_state(), m.obs, K_T)) < 1.0
    gt = ttraj.camera_centers(torch.from_numpy(rv[perm]), torch.from_numpy(tv[perm]))
    ate = float(ttraj.ate_rmse(ttraj.camera_centers(m.rvecs, m.tvecs), gt))
    assert ate < 0.05 * float(np.linalg.norm(np.ptp(gt.numpy(), axis=0)))


def _seeded_sampler(kind, frame, valid, n_hyp, n_pts):
    """Draws that depend on (kind, frame) alone, so a resumed run draws what
    the uninterrupted one drew."""
    g = torch.Generator().manual_seed(1000 * ("init", "pnp", "loop").index(kind) + frame)
    w = valid.to(torch.float32) + (~valid.any()).to(torch.float32)
    return torch.multinomial(w, n_hyp * n_pts, replacement=True, generator=g).view(n_hyp, n_pts)


def test_checkpoint_resume_equals_uninterrupted_run(scene, tmp_path):
    feats = [tfe.features_from_numpy(f, "cpu") for f in scene[0]]
    kw = dict(RUN_KW, loop_closure=False, sampler=_seeded_sampler)
    full = tsfm.run_sfm(None, feats, K_T, **kw)
    d = tmp_path / "ck"
    first = tsfm.run_sfm(None, feats, K_T, checkpoint_dir=str(d), checkpoint_every=2, **kw)
    assert tckpt.latest_step(d) == N_FRAMES - 1
    assert all(torch.equal(a, b) for a, b in zip(first[:-1], full[:-1]))
    # Resumed from the last frame's checkpoint, only the final BA runs again:
    # the same map, bit for bit.
    resumed = tsfm.run_sfm(None, feats, K_T, checkpoint_dir=str(d), checkpoint_every=2, **kw)
    assert all(torch.equal(a, b) for a, b in zip(resumed[:-1] + tuple(resumed.obs),
                                                 full[:-1] + tuple(full.obs)))
    # A crash after frame 4: the last checkpoint is gone and the rerun
    # registers frames 5 and 6 again. The previous frame's used-keypoint mask
    # is not in a checkpoint (as in the JAX driver), so frame 5 may birth a
    # few duplicate landmarks: the trajectory within 2% of its extent.
    (d / f"step_{N_FRAMES - 1}").unlink()
    assert tckpt.latest_step(d) == 4
    again = tsfm.run_sfm(None, feats, K_T, checkpoint_dir=str(d), checkpoint_every=2, **kw)
    assert int(again.cam_valid.sum()) == N_FRAMES and tckpt.latest_step(d) == N_FRAMES - 1
    extent = float(np.ptp(full.tvecs.numpy(), axis=0).max())
    np.testing.assert_allclose(again.tvecs.numpy(), full.tvecs.numpy(), atol=0.02 * extent)
    np.testing.assert_allclose(again.rvecs.numpy(), full.rvecs.numpy(), atol=2e-3)


def test_checkpoint_fingerprint_and_refusals(scene, tmp_path):
    feats = [tfe.features_from_numpy(f, "cpu") for f in scene[0][:4]]
    d = tmp_path / "ck"
    gen = torch.Generator().manual_seed(0)
    tsfm.run_sfm(gen, feats, K_T, checkpoint_dir=str(d), checkpoint_every=2, **RUN_KW)
    with pytest.raises(ValueError, match="fingerprint mismatch.*pts_per_frame"):
        tsfm.run_sfm(gen, feats, K_T, checkpoint_dir=str(d), checkpoint_every=2,
                     **dict(RUN_KW, pts_per_frame=32))
    m = tsfm.empty_map(4, B, device="cpu")
    with pytest.raises(ValueError, match="lacks 'run' and no compatibility default"):
        tckpt.load_pytree(d, m, meta={"run": 1})
    # A key missing from the saved fingerprint passes at its declared default.
    _m, step = tckpt.load_pytree(d, m, meta={"run": 1}, meta_defaults={"run": 1})
    assert step == 3
    with pytest.raises(ValueError, match="structure, shapes and dtypes"):
        tckpt.load_pytree(d, tsfm.empty_map(5, B, device="cpu"))
    with pytest.raises(FileNotFoundError):
        tckpt.load_pytree(tmp_path / "none", m)
    with pytest.raises(ValueError, match="covisibility"):
        tsfm.run_sfm(gen, feats, K_T, checkpoint_dir=str(d), pair_selection="covisibility",
                     **RUN_KW)
    with pytest.raises(ValueError, match="pair_selection"):
        tsfm.run_sfm(gen, feats, K_T, pair_selection="random")
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        tsfm.run_sfm(gen, feats, K_T, pgo_mesh=object())


def test_cli_sfm_on_cpu(tmp_path, capsys):
    """``cli sfm`` renders 4 frames with the native renderer, runs the port's
    frontend (dual orientations, 256 keypoints) and run_sfm on the CPU; the
    trajectory it writes reads back through the JAX package."""
    from sift_parallel_optimization_tpu_torch.utils import native

    assert native._load() is not None, native._build_error
    traj = tmp_path / "traj.txt"
    rc = tcli.main(["sfm", "--device", "cpu", "--frames", "4", "--size", "192",
                    "--save-traj", str(traj)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "cameras: 4/4" in out and "reprojection RMS:" in out
    ate = float(out.split("ATE (Sim3-aligned): ")[1].split()[0])
    span = float(out.split("trajectory span ")[1].rstrip(")\n").split(")")[0])
    assert ate < 0.1 * span, out
    ts, centers, _q = jtraj.load_tum(traj)
    np.testing.assert_array_equal(ts, np.arange(4.0))
    assert centers.shape == (4, 3)


@pytest.mark.parametrize("seed", [0, 5])
def test_render_frame_fallback_matches_native(seed):
    """The NumPy renderer (the card machine has no libpng, so no native
    library) against the native one: the same scene and noise; exp may
    differ in the last bit, so 1e-5."""
    from sift_parallel_optimization_tpu_torch.utils import native

    assert native._load() is not None, native._build_error
    rv = np.array([0.0, 0.03 * seed, 0.01], np.float32)
    tv = np.array([-0.35 * seed, 0.02, 0.04 * seed], np.float32)
    want = native.render_frame(96, rv, tv, 96.0, seed=seed)
    got = native._render_frame_numpy(96, rv, tv, 96.0, seed)
    assert got.dtype == np.float32 and got.shape == (96, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
