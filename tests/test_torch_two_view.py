"""The port's two-view path against the JAX package on the CPU:
``init_two_view`` and ``ransac_pnp`` on a synthetic-feature scene with the
JAX package's RANSAC draws injected, the state converters, and the slice as
a whole (frames -> batched frontend -> match -> homography) against the JAX
chain on a translated texture pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu.models import geometry as jgeo
from sift_parallel_optimization_tpu.models import matching as jm
from sift_parallel_optimization_tpu.models import sfm as jsfm
from sift_parallel_optimization_tpu.models.keypoints import Keypoints as JKeypoints
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models import geometry as tgeo
from sift_parallel_optimization_tpu_torch.models import matching as tm
from sift_parallel_optimization_tpu_torch.models import sfm as tsfm
from sift_parallel_optimization_tpu_torch.parallel.frontend import batched_extract_features

K_NP = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)
K_J, K_T = jnp.asarray(K_NP), torch.from_numpy(K_NP)
W, H = 400, 300
CAPACITY, PTS_PER_FRAME = 128, 64
# Pose and landmarks: both sides run the same fp32 closed forms on the same
# hypotheses; what differs is the SVDs' and matmuls' summation order.
POSE_ATOL = 1e-3
# The JAX side under jax.jit, compiled once for every case that shares it.
J_INIT = jax.jit(lambda k, a, b, m: jsfm.init_two_view(
    k, a, b, K_J, m, PTS_PER_FRAME, return_used_pair=True))
J_MATCH = jax.jit(jm.match_descriptors)
J_MATCHED_POINTS = jax.jit(jm.matched_points)
J_DRAWS = jax.jit(jm._sample_indices, static_argnums=(2, 3))
J_PROJECT = jax.jit(lambda pts, rvec, tvec: jgeo.project(pts, rvec, tvec, K_J))


def t(a):
    return torch.from_numpy(np.array(a))


def _make_features(rng, pts, descs, rvec, tvec, capacity, px_noise=0.2):
    """tests/test_sfm.py's synthetic features, as numpy dicts."""
    uv, z = J_PROJECT(jnp.asarray(pts), jnp.asarray(rvec), jnp.asarray(tvec))
    uv = np.asarray(uv) + rng.normal(size=uv.shape).astype(np.float32) * px_noise
    z = np.asarray(z)
    vis = ((z > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < W - 5)
           & (uv[:, 1] > 5) & (uv[:, 1] < H - 5))
    n = pts.shape[0]
    pad = capacity - n
    d = descs + rng.normal(size=descs.shape).astype(np.float32) * 0.03
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    p = lambda a: np.pad(a, (0, pad))
    return {
        "keypoints": {
            "x": p(uv[:, 0]), "y": p(uv[:, 1]),
            "sigma": p(np.full(n, 2.0, np.float32)), "score": p(np.full(n, 1.0, np.float32)),
            "orientation": np.zeros(capacity, np.float32),
            "octave": np.zeros(capacity, np.int32), "scale": np.ones(capacity, np.int32),
            "valid": p(vis),
        },
        "descriptors": np.pad(d, ((0, pad), (0, 0))).astype(np.float32),
    }


def _jax_features(arrays):
    return jfe.Features(
        keypoints=JKeypoints(**{f: jnp.asarray(v) for f, v in arrays["keypoints"].items()}),
        descriptors=jnp.asarray(arrays["descriptors"]),
    )


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    n_pts = 100
    pts = rng.uniform(-3, 3, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(6, 12, size=n_pts)
    descs = rng.normal(size=(n_pts, 128)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    poses = [(np.array([0.0, 0.05 * i, 0.0], np.float32),
              np.array([-0.35 * i, 0.02 * i, 0.05 * i], np.float32)) for i in range(3)]
    feats = [_make_features(rng, pts, descs, rv, tv, CAPACITY) for rv, tv in poses]
    return pts, poses, feats


_BOOTSTRAPS: dict = {}


def _bootstrap(scene, key_seed):
    """(JAX map and used masks, the port's) from one injected draw; computed
    once per draw for the tests that share it."""
    if key_seed not in _BOOTSTRAPS:
        _BOOTSTRAPS[key_seed] = _run_bootstrap(scene, key_seed)
    return _BOOTSTRAPS[key_seed]


def _run_bootstrap(scene, key_seed):
    _pts, _poses, feats = scene
    jf0, jf1 = _jax_features(feats[0]), _jax_features(feats[1])
    key = jax.random.key(key_seed)
    jmap0 = jsfm.empty_map(3, PTS_PER_FRAME)
    want = J_INIT(key, jf0, jf1, jmap0)
    match = J_MATCH(jf0.descriptors, jf1.descriptors, jf0.keypoints.valid, jf1.keypoints.valid)
    _p0, _p1, pair_ok = J_MATCHED_POINTS(jf0.keypoints, jf1.keypoints, match)
    idx = np.array(J_DRAWS(key, pair_ok, 512, 8))
    tf0, tf1 = tfe.features_from_numpy(feats[0], "cpu"), tfe.features_from_numpy(feats[1], "cpu")
    tmap0 = tsfm.empty_map(3, PTS_PER_FRAME, device="cpu")
    got = tsfm.init_two_view(None, tf0, tf1, K_T, tmap0, PTS_PER_FRAME,
                             return_used_pair=True, sample_idx=t(idx))
    return want, got, tmap0


@pytest.mark.parametrize("key_seed", [0, 1])
def test_init_two_view_matches_jax_with_injected_draws(scene, key_seed):
    _pts, poses, _feats = scene
    (jmap, jused_a, jused_b), (tmap, used_a, used_b), tmap0 = _bootstrap(scene, key_seed)
    got = tsfm.sfm_map_to_numpy(tmap)
    np.testing.assert_array_equal(got["cam_valid"], np.asarray(jmap.cam_valid))
    np.testing.assert_array_equal(got["cam_valid"], [True, True, False])
    np.testing.assert_array_equal(got["pt_valid"], np.asarray(jmap.pt_valid))
    assert got["pt_valid"].sum() >= 25
    for f in ("cam_idx", "pt_idx", "valid"):
        np.testing.assert_array_equal(got["obs"][f], np.asarray(getattr(jmap.obs, f)), err_msg=f)
    np.testing.assert_array_equal(got["obs"]["uv"], np.asarray(jmap.obs.uv))   # copies
    np.testing.assert_array_equal(used_a.numpy(), np.asarray(jused_a))
    np.testing.assert_array_equal(used_b.numpy(), np.asarray(jused_b))
    for f in ("rvecs", "tvecs"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jmap, f)), atol=POSE_ATOL,
                                   err_msg=f)
    v = got["pt_valid"]
    # Landmarks at depth 6-12 in units of the unit baseline (true 0.35):
    # relative 1e-3.
    np.testing.assert_allclose(got["points"][v], np.asarray(jmap.points)[v], rtol=POSE_ATOL,
                               atol=POSE_ATOL * 30)
    np.testing.assert_array_equal(got["pt_desc"], np.asarray(jmap.pt_desc))
    # The pose is the truth's, up to the free scale. F is the winning MINIMAL
    # sample's, not a refit over its inliers, and 0.2 px noise over a 0.35
    # baseline leaves its translation direction loose: 1 degree of rotation,
    # 30 degrees of direction (the JAX package's pose, equal above, is as far).
    rv, tv = poses[1]
    np.testing.assert_allclose(got["rvecs"][1], rv, atol=np.deg2rad(1.0))
    cos = got["tvecs"][1] @ tv / np.linalg.norm(tv) / np.linalg.norm(got["tvecs"][1])
    assert cos > np.cos(np.deg2rad(30.0))
    # Pure function: the map handed in is untouched.
    assert not bool(tmap0.cam_valid.any()) and not bool(tmap0.obs.valid.any())


def test_init_two_view_other_slots_and_generator(scene):
    _pts, _poses, feats = scene
    tf0, tf1 = tfe.features_from_numpy(feats[0], "cpu"), tfe.features_from_numpy(feats[1], "cpu")
    m0 = tsfm.empty_map(3, PTS_PER_FRAME, device="cpu")
    gen = torch.Generator().manual_seed(3)
    m, used_b = tsfm.init_two_view(gen, tf0, tf1, K_T, m0, PTS_PER_FRAME,
                                   slot_a=torch.tensor(1), slot_b=2)
    assert m.cam_valid.tolist() == [False, True, True]
    assert int(m.n_cameras()) == 2 and int(m.n_points()) >= 25
    B = PTS_PER_FRAME
    assert not bool(m.pt_valid[:B].any()) and bool(m.pt_valid[B:2 * B].any())
    blk = m.obs.valid[3 * B:4 * B]
    assert bool(blk.any()) and torch.equal(blk, m.obs.valid[4 * B:5 * B])
    assert set(m.obs.cam_idx[3 * B:4 * B].tolist()) == {1}
    assert set(m.obs.cam_idx[4 * B:5 * B].tolist()) == {2}
    assert int(used_b.sum()) == int(m.n_points())
    assert m.ba_state().points.shape == (3 * B, 3)
    with pytest.raises(ValueError, match="Generator or sample_idx"):
        tsfm.init_two_view(None, tf0, tf1, K_T, m0, PTS_PER_FRAME)


def test_ransac_pnp_matches_jax_with_injected_draws(scene):
    pts, poses, feats = scene
    (jmap, _ja, _jb), (tmap, _a, _b), _m0 = _bootstrap(scene, 0)
    # Register frame 2 against the bootstrap landmarks: 2D-3D by descriptor.
    jf2 = _jax_features(feats[2])
    match = J_MATCH(jmap.pt_desc, jf2.descriptors, jmap.pt_valid, jf2.keypoints.valid)
    idx2 = np.asarray(match.idx2)
    pts2d = np.stack([feats[2]["keypoints"]["x"][idx2], feats[2]["keypoints"]["y"][idx2]], -1)
    mask = np.asarray(match.valid) & feats[2]["keypoints"]["valid"][idx2]
    assert mask.sum() >= 30
    pts3d = np.asarray(jmap.points)           # the same landmarks on both sides
    key = jax.random.key(7)
    want = jax.jit(lambda k, a, b, m: jsfm.ransac_pnp(k, a, b, m, K_J, n_hypotheses=64))(
        key, jnp.asarray(pts3d), jnp.asarray(pts2d), jnp.asarray(mask))
    idx = np.array(J_DRAWS(key, jnp.asarray(mask), 64, 6))
    cam, inliers, n = tsfm.ransac_pnp(None, t(pts3d), t(pts2d), t(mask), K_T, n_hypotheses=64,
                                      sample_idx=t(idx))
    # Minimal 6-point hypotheses are ill-conditioned in fp32, so the two
    # sides may crown different ones; the final LU refinement over the
    # winner's inliers brings both to the same least-squares pose.
    assert (inliers.numpy() != np.asarray(want[1])).sum() <= 1
    assert abs(int(n) - int(want[2])) <= 1 and int(n) >= mask.sum() - 3
    np.testing.assert_allclose(cam.rvec.numpy(), np.asarray(want[0].rvec), atol=POSE_ATOL)
    np.testing.assert_allclose(cam.tvec.numpy(), np.asarray(want[0].tvec), atol=POSE_ATOL)
    err = tgeo.reprojection_error(cam, t(pts3d), t(pts2d), K_T).numpy()
    assert np.median(err[inliers.numpy()]) < 1.0


def test_feature_and_map_converters_round_trip(scene):
    _pts, _poses, feats = scene
    f = tfe.features_from_numpy(feats[0], "cpu")
    assert f.keypoints.valid.dtype == torch.bool and f.keypoints.octave.dtype == torch.int32
    back = tfe.features_to_numpy(f)
    for k, v in feats[0]["keypoints"].items():
        np.testing.assert_array_equal(back["keypoints"][k], v)
    np.testing.assert_array_equal(back["descriptors"], feats[0]["descriptors"])
    # Named tuples of (JAX) arrays are taken as they are, batch axis kept.
    jf = _jax_features(feats[0])
    stacked = jax.tree.map(lambda a: jnp.stack([a, a]), jf)
    f2 = tfe.features_from_numpy(stacked, "cpu")
    assert f2.descriptors.shape == (2, CAPACITY, 128)
    assert torch.equal(f2.keypoints.x[1], f.keypoints.x)
    jmap = jsfm.empty_map(2, 8)._replace(cam_valid=jnp.asarray([True, False]))
    m = tsfm.sfm_map_from_numpy(jmap, "cpu")
    assert m.obs.cam_idx.dtype == torch.int32 and m.cam_valid.tolist() == [True, False]
    back = tsfm.sfm_map_to_numpy(m)
    assert back["obs"]["uv"].shape == (3 * 16 + 8 * 8, 2)
    m2 = tsfm.sfm_map_from_numpy(back, "cpu")
    for a, b in zip(m[:-1] + tuple(m.obs), m2[:-1] + tuple(m2.obs)):
        assert torch.equal(a, b)
    e = tsfm.empty_map(2, 8, device="cpu")
    assert [tuple(x.shape) for x in e[:-1]] == [tuple(np.shape(x)) for x in jmap[:-1]]


def _texture_pair(rng, size=128):
    """tests/test_matching.py's translated-texture pair."""
    from jax.scipy.signal import convolve2d

    full = size + 16
    y, x = np.mgrid[0:full, 0:full].astype(np.float32)
    big = np.full((full, full), 0.5, np.float32)
    for _ in range(40):
        cy, cx = rng.uniform(8, full - 8, 2)
        s = rng.uniform(2.0, 6.0)
        a = rng.uniform(-0.4, 0.4)
        big += a * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
    noise = rng.random((full, full)).astype(np.float32)
    k = np.ones((3, 3), np.float32) / 9
    noise = np.asarray(convolve2d(jnp.asarray(noise), jnp.asarray(k), "same"))
    big += 0.3 * (noise - noise.mean())
    return np.stack([big[:size, :size], big[8:8 + size, 8:8 + size]]).astype(np.float32)


def test_slice_frames_to_homography_matches_jax(rng):
    size, k = 128, 256
    imgs = _texture_pair(rng, size)
    jcfg = jfe.sift_config(size)
    extract = jax.jit(lambda im: jfe.extract_features(im, jcfg, max_keypoints=k))
    jf = [extract(jnp.asarray(im)) for im in imgs]
    jmatch = J_MATCH(jf[0].descriptors, jf[1].descriptors,
                     jf[0].keypoints.valid, jf[1].keypoints.valid)
    jp1, jp2, jmask = J_MATCHED_POINTS(jf[0].keypoints, jf[1].keypoints, jmatch)
    key = jax.random.key(0)
    want = jax.jit(lambda k, a, b, m: jm.ransac_homography(
        k, a, b, m, n_hypotheses=64, threshold=1.5))(key, jp1, jp2, jmask)

    feats = batched_extract_features(torch.from_numpy(imgs), tfe.sift_config(size),
                                     max_keypoints=k)
    f0, f1 = (tfe.Features(type(feats.keypoints)(*[f[i] for f in feats.keypoints]),
                           feats.descriptors[i]) for i in range(2))
    match = tm.match_descriptors(f0.descriptors, f1.descriptors, f0.keypoints.valid,
                                 f1.keypoints.valid)
    p1, p2, mask = tm.matched_points(f0.keypoints, f1.keypoints, match)
    # Same keypoints (1e-3 px: the batched pyramid reassociates) and the same
    # pairs, so the JAX draws index the same slots.
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(match.idx2.numpy()[mask.numpy()],
                                  np.asarray(jmatch.idx2)[mask.numpy()])
    np.testing.assert_allclose(p1.numpy(), np.asarray(jp1), atol=1e-3)
    assert int(mask.sum()) >= 10
    idx = np.array(J_DRAWS(key, jmask, 64, 4))
    got = tm.ransac_homography(None, p1, p2, mask, n_hypotheses=64, threshold=1.5,
                               sample_idx=t(idx))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) >= int(mask.sum()) * 2 // 3
    h = got.model.numpy() / got.model.numpy()[2, 2]
    jh = np.asarray(want.model) / np.asarray(want.model)[2, 2]
    # Translations in pixels at 1e-2, the rest of H at 1e-3.
    np.testing.assert_allclose(h[:, 2], jh[:, 2], atol=1e-2)
    np.testing.assert_allclose(h[:, :2], jh[:, :2], atol=1e-3)
    assert abs(h[0, 2] + 8) < 1.0 and abs(h[1, 2] + 8) < 1.0
    assert abs(h[0, 0] - 1) < 0.05 and abs(h[1, 1] - 1) < 0.05
