"""The port's windowed odometry (``models/odometry``) against the JAX package
on the CPU: the window-map operations (shift, anchor harvest), the landmark
archive (ring writes and wraps, the coverage policy's slot), the loop
proposal and the device-side loop buffer, the Sim(3) drift helpers,
``correct_trajectory`` (Sim(3) and SE(3)), and ``run_odometry`` with loop
closure on a synthetic out-and-back scene with the JAX key chain's draws
replayed; then checkpoint resume, run_odometry's argument checks, and
``cli sfm --window --loop-closure --device cpu``.

The features are synthetic (``utils/synthetic``), so matching, PnP,
triangulation, window BA, the archive and the pose graph are tested apart
from the image frontend. The steady step runs eagerly here (``graph=False``:
a CUDA graph needs the card; ``chip_smoke.py`` holds the captured step
against the eager one there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import ba as jba
from sift_parallel_optimization_tpu.models import matching as jm
from sift_parallel_optimization_tpu.models import odometry as jodo
from sift_parallel_optimization_tpu.models import sfm as jsfm
from sift_parallel_optimization_tpu.models.frontend import Features as JFeatures
from sift_parallel_optimization_tpu.models.keypoints import Keypoints as JKeypoints
from sift_parallel_optimization_tpu_torch import cli as tcli
from sift_parallel_optimization_tpu_torch.models import ba as tba
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models import odometry as todo
from sift_parallel_optimization_tpu_torch.models import sfm as tsfm
from sift_parallel_optimization_tpu_torch.utils import checkpoint as tckpt
from sift_parallel_optimization_tpu_torch.utils import synthetic
from sift_parallel_optimization_tpu_torch.utils import trajectory as ttraj

K_NP = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)
K_J, K_T = jnp.asarray(K_NP), torch.from_numpy(K_NP)
# The run's scene: 14 frames out 6 steps of 1.0 and back 7 (so loops close),
# 300 landmarks in a box along the path, a window of 4 and 64 landmarks a
# frame.
N_FRAMES, W, B, N_PTS, CAPACITY = 14, 4, 64, 300, 320
STEP = (-1.0, 0.03, 0.07)
RUN_KW = dict(window=W, pts_per_frame=B)
# Poses of the run against JAX's with the same draws. Every registration and
# window BA agrees to ~1e-4 between the packages and the frozen chain adds
# them up without a final global BA; a 2e-5 px nudge of the keypoints moves
# the port's own run by 2.8e-3 rad and 4.7e-3 in translation (measured on
# this scene; JAX against the port read 3.2e-3 rad and 2.4e-3). So rotations
# within 5e-3 rad, translations within 5e-3 of the largest (the run_sfm
# test's relative bound; the scale is the bootstrap pair's unit baseline).
RUN_R_ATOL, RUN_T_RTOL = 5e-3, 5e-3
# Loop inlier counts: a point at the 3 px threshold may fall on the other
# side in one package (measured 124 / 121 and 34 / 33).
INLIER_ATOL = 5


def _jax_features(arrays):
    return JFeatures(JKeypoints(**{k: jnp.asarray(v) for k, v in arrays["keypoints"].items()}),
                     jnp.asarray(arrays["descriptors"]))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    pts, descs = synthetic.landmarks(rng, N_PTS, lo=(-5, -3, 6), hi=(12, 3, 12))
    rv, tv = synthetic.out_and_back(N_FRAMES, step=STEP)
    feats = [synthetic.view_features(rng, pts, descs, rv[i], tv[i], K_NP, 400, 300, CAPACITY)
             for i in range(N_FRAMES)]
    return feats, (rv, tv)


_DRAW = jax.jit(jm._sample_indices, static_argnums=(2, 3))


def jax_sampler(key):
    """``run_odometry``'s sampler giving the JAX run's draws: frame i's
    key is ``fold_in(key, i)`` (the bootstrap takes frame 0's directly,
    registration splits it), the loop proposal's ``fold_in(fold_in(key,
    11), i)``."""
    loop_base = jax.random.fold_in(key, 11)

    def sample(kind, frame, valid, n_hyp, n_pts):
        k = {"init": lambda: jax.random.fold_in(key, 0),
             "pnp": lambda: jax.random.split(jax.random.fold_in(key, frame))[0],
             "loop": lambda: jax.random.fold_in(loop_base, frame)}[kind]()
        return np.array(_DRAW(k, jnp.asarray(valid.cpu().numpy()), n_hyp, n_pts))

    return sample


def _ate(traj, rv, tv):
    gt = ttraj.camera_centers(torch.from_numpy(rv), torch.from_numpy(tv))
    span = float(np.linalg.norm(np.ptp(gt.numpy(), axis=0)))
    return float(ttraj.ate_rmse(ttraj.camera_centers(traj.rvecs, traj.tvecs), gt)), span


def _random_map(rng, Wm, Bm):
    """A window map of random content: every field, with random valid masks
    and observation indices in range."""
    C, P, M = Wm, Wm * Bm, 3 * Wm * Bm
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "rvecs": f(C, 3), "tvecs": f(C, 3), "cam_valid": rng.random(C) < 0.8,
        "points": f(P, 3), "pt_valid": rng.random(P) < 0.7, "pt_desc": f(P, 128),
        "obs": {"cam_idx": rng.integers(0, C, M).astype(np.int32),
                "pt_idx": rng.integers(0, P, M).astype(np.int32),
                "uv": f(M, 2), "valid": rng.random(M) < 0.8},
    }


def _jax_map(d):
    return jsfm.SfmMap(**{k: jnp.asarray(v) for k, v in d.items() if k != "obs"},
                       obs=jba.Observations(**{k: jnp.asarray(v) for k, v in d["obs"].items()}))


def _assert_tuples_equal(got, want):
    for name, g, w in zip(got._fields, got, want):
        if isinstance(g, tuple):
            _assert_tuples_equal(g, w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_shift_window_matches_jax(rng):
    d = _random_map(rng, 4, 3)
    got = todo.shift_window(tsfm.sfm_map_from_numpy(d, "cpu"), 3)
    want = jax.jit(jodo.shift_window, static_argnums=1)(_jax_map(d), 3)
    _assert_tuples_equal(got, want)
    assert not bool(got.cam_valid[-1]) and not bool(got.obs.valid[-9:].any())


def test_harvest_anchors_matches_jax(rng):
    """Two harvests in a row on a random map (the second shifts and expires
    the first's anchors), field for field against JAX, including the order
    of the compacted anchors (stable argsorts on both sides)."""
    d = _random_map(rng, 4, 3)
    t_anc, j_anc = tba.empty_anchors(9, "cpu"), jba.empty_anchors(9)
    harvest = jax.jit(jodo.harvest_anchors, static_argnums=(2, 3))
    tm, jmap = tsfm.sfm_map_from_numpy(d, "cpu"), _jax_map(d)
    for _ in range(2):
        t_anc = todo.harvest_anchors(tm, t_anc, 3, per_eviction=3)
        j_anc = harvest(jmap, j_anc, 3, 3)
        _assert_tuples_equal(t_anc, j_anc)
        assert 0 < int(t_anc.valid.sum()) <= 9
        assert bool((t_anc.cam_idx[t_anc.valid] >= 1).all())


def test_archive_ring_and_coverage_slot_match_jax(rng):
    """Four evictions into a 3-block ring (the fourth wraps onto block 0)
    with FIFO slots, then the coverage policy's slot on random archives at
    several frames: the archive field for field and the chosen block equal
    JAX's."""
    Bm, A = 2, 6
    d = _random_map(rng, 3, Bm)
    tm, jmap = tsfm.sfm_map_from_numpy(d, "cpu"), _jax_map(d)
    t_arch, j_arch = todo.empty_archive(A, "cpu"), jodo.empty_archive(A)
    write = jax.jit(jodo.archive_evicted_block, static_argnums=4)
    for slot in range(4):
        t_arch = todo.archive_evicted_block(t_arch, tm, slot, 10 + slot, Bm)
        j_arch = write(j_arch, jmap, jnp.int32(slot), jnp.int32(10 + slot), Bm)
        _assert_tuples_equal(t_arch, j_arch)
    np.testing.assert_array_equal(t_arch.birth.numpy(), [13, 13, 11, 11, 12, 12])
    slot_fn = jax.jit(jodo.coverage_write_slot, static_argnums=(3, 4))
    for trial in range(6):
        nb, Bc = 5, 3
        arch = {"positions": (rng.normal(size=(nb * Bc, 3)) * 5).astype(np.float32),
                "desc": np.zeros((nb * Bc, 128), np.float32),
                "birth": np.repeat(rng.integers(0, 30, nb), Bc).astype(np.int32),
                "valid": np.repeat(rng.random(nb) < (0.6 if trial % 2 else 1.1), Bc)}
        dm = _random_map(rng, 3, Bc)
        now = int(rng.integers(10, 40))
        got = todo.coverage_write_slot(todo.archive_from_numpy(arch, "cpu"),
                                       tsfm.sfm_map_from_numpy(dm, "cpu"), now - 3, 6, Bc,
                                       now_frame=now)
        want = slot_fn(jodo.LandmarkArchive(**{k: jnp.asarray(v) for k, v in arch.items()}),
                       _jax_map(dm), now - 3, 6, Bc, now)
        assert got.dtype == torch.int32 and int(got) == int(want), trial


def test_loop_buffer_accept_semantics_match_jax():
    """tests/test_odometry.py's sequence (threshold, cooldown, capacity, the
    dropped counter), the whole buffer against JAX's after every step; the
    frame index as a Python int and as a 0-d tensor."""
    def prop(lib, n, birth=3):
        a = jnp if lib is jodo else torch
        mk = (lambda v, dt: jnp.asarray(v, dt)) if a is jnp else (
            lambda v, dt: torch.tensor(v, dtype=dt))
        i32, f32 = (jnp.int32, jnp.float32) if a is jnp else (torch.int32, torch.float32)
        return lib.ArchiveLoop(rvec=mk([1.0] * 3, f32), tvec=mk([2.0] * 3, f32),
                               n_inliers=mk(n, i32), birth=mk(birth, i32))

    t_buf, j_buf = todo.empty_loop_buffer(2, "cpu"), jodo.empty_loop_buffer(2)
    step = jax.jit(lambda b, p, i: jodo.accept_loop_proposal(b, p, i, min_inliers=25, cooldown=3))
    for k, (n, frame) in enumerate(((10, 10), (30, 11), (40, 13), (40, 15), (50, 19))):
        fi = frame if k % 2 else torch.tensor(frame, dtype=torch.int32)
        t_buf = todo.accept_loop_proposal(t_buf, prop(todo, n), fi, 25, 3)
        j_buf = step(j_buf, prop(jodo, n), frame)
        _assert_tuples_equal(t_buf, j_buf)
    assert int(t_buf.count) == 2 and int(t_buf.n_dropped) == 1
    np.testing.assert_array_equal(t_buf.frames.numpy(), [11, 15])


def test_uniform_draws_cover_only_valid_slots():
    """The steady step's draws: only valid slots, each about equally often;
    with no valid slot, every slot."""
    valid = torch.zeros(64, dtype=torch.bool)
    valid[torch.tensor([3, 10, 11, 40, 63])] = True
    u = torch.rand(20_000, generator=torch.Generator().manual_seed(0))
    idx = todo.uniform_draws(u)(valid, 2_500, 8)
    assert idx.shape == (2_500, 8) and idx.dtype == torch.int64
    counts = torch.bincount(idx.flatten(), minlength=64)
    assert set(torch.nonzero(counts).flatten().tolist()) == {3, 10, 11, 40, 63}
    assert float(counts[valid].float().std() / counts[valid].float().mean()) < 0.05
    none = todo.uniform_draws(u)(torch.zeros(64, dtype=torch.bool), 100, 6)
    assert int(none.min()) >= 0 and int(none.max()) <= 63 and len(set(none.flatten().tolist())) > 50


def test_propose_archive_loop_matches_jax(scene):
    """An archive of the scene's frame-0 landmarks (births 0..3 by block),
    frame 12 (back near the start) proposed against it with JAX's draws:
    the same pose (1e-3), inliers within a few, the same median birth."""
    feats, (rv, tv) = scene
    rng = np.random.default_rng(1)
    pts, descs = synthetic.landmarks(np.random.default_rng(0), N_PTS, lo=(-5, -3, 6),
                                     hi=(12, 3, 12))
    A = 256
    arch = {"positions": pts[:A], "desc": descs[:A] + 0.01 * rng.normal(
                size=(A, 128)).astype(np.float32),
            "birth": np.repeat(np.arange(4), A // 4).astype(np.int32),
            "valid": rng.random(A) < 0.9}
    t_arch = todo.archive_from_numpy(arch, "cpu")
    j_arch = jodo.LandmarkArchive(**{k: jnp.asarray(v) for k, v in arch.items()})
    key = jax.random.key(4)
    want = jax.jit(lambda k, f, a: jodo.propose_archive_loop(k, f, a, 12, K_J, min_gap=9))(
        key, _jax_features(feats[12]), j_arch)
    draws = lambda valid, n, k: np.array(_DRAW(key, jnp.asarray(valid.numpy()), n, k))
    got = todo.propose_archive_loop(None, tfe.features_from_numpy(feats[12], "cpu"), t_arch, 12,
                                    K_T, min_gap=9, sample_idx=draws)
    assert int(want.n_inliers) > 50
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= INLIER_ATOL
    assert int(got.birth) == int(want.birth) and got.birth.dtype == torch.int32
    np.testing.assert_allclose(got.rvec.numpy(), np.asarray(want.rvec), atol=1e-3)
    np.testing.assert_allclose(got.tvec.numpy(), np.asarray(want.tvec), atol=1e-3)
    # Only landmarks born <= 12 - 9 = 3 count: with min_gap 13 nothing is old.
    none = todo.propose_archive_loop(None, tfe.features_from_numpy(feats[12], "cpu"), t_arch,
                                     12, K_T, min_gap=13, sample_idx=draws)
    assert int(none.n_inliers) == 0 and int(none.birth) == 0


def test_sim3_helpers_match_jax(rng):
    """landmark_sim3 recovers a similarity applied to archived landmarks, as
    JAX's does; apply_sim3_map / apply_sim3_poses / pnp_sim3 equal JAX's."""
    d = _random_map(rng, 3, 8)
    d["pt_valid"][:] = True
    s, ang, t = 1.3, 0.2, np.array([0.5, -0.2, 0.3], np.float32)
    R = synthetic.rodrigues_np([0.0, ang, 0.05]).astype(np.float32)
    A = d["points"].shape[0]
    arch = {"positions": (s * d["points"] @ R.T + t).astype(np.float32),
            "desc": d["pt_desc"] / np.linalg.norm(d["pt_desc"], axis=-1, keepdims=True),
            "birth": np.zeros(A, np.int32), "valid": np.ones(A, bool)}
    d["pt_desc"] = arch["desc"]
    tm, jmap = tsfm.sfm_map_from_numpy(d, "cpu"), _jax_map(d)
    t_arch = todo.archive_from_numpy(arch, "cpu")
    j_arch = jodo.LandmarkArchive(**{k: jnp.asarray(v) for k, v in arch.items()})
    g = todo.landmark_sim3(tm, t_arch, 20)
    jg = jax.jit(jodo.landmark_sim3)(jmap, j_arch, 20)
    np.testing.assert_allclose(float(g.s), s, rtol=1e-4)
    np.testing.assert_allclose(g.r.numpy(), R, atol=1e-4)
    for a, b in zip(g[:3], jg[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert int(g.n_pairs) == int(jg.n_pairs) == A
    for f_t, f_j in ((lambda: todo.apply_sim3_map(tm, g), lambda: jodo.apply_sim3_map(jmap, jg)),
                     (lambda: todo.pnp_sim3(tm, 1, g.r[0], g.t),
                      lambda: jodo.pnp_sim3(jmap, 1, jg.r[0], jg.t))):
        for a, b in zip(f_t(), f_j()):
            if isinstance(a, torch.Tensor):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


@pytest.fixture(scope="module")
def runs(scene):
    """JAX's run_odometry with loop closure and the port's with JAX's draws
    replayed, and the port's windowed-only run."""
    feats, _poses = scene
    key = jax.random.key(0)
    want = jodo.run_odometry(key, [_jax_features(f) for f in feats], K_J, loop_closure=True,
                             return_info=True, **RUN_KW)
    tf = [tfe.features_from_numpy(f, "cpu") for f in feats]
    got = todo.run_odometry(None, tf, K_T, loop_closure=True, return_info=True,
                            sampler=jax_sampler(key), **RUN_KW)
    windowed = todo.run_odometry(None, tf, K_T, sampler=jax_sampler(key), **RUN_KW)
    return want, got, windowed


def test_run_odometry_matches_jax_with_replayed_draws(scene, runs):
    (jt, jmap, jinfo), (traj, m, info), (w_traj, _wm) = runs
    rv, tv = scene[1]
    # The same loops accepted, none dropped; the buffer read once.
    assert len(info["loop_frames"]) >= 1 and info["loop_frames"] == jinfo["loop_frames"]
    assert info["loops_dropped"] == jinfo["loops_dropped"] == 0
    assert np.abs(np.subtract(info["loop_inliers"], jinfo["loop_inliers"])).max() <= INLIER_ATOL
    assert info["graph_replays"] == 0
    # O(window) capacities, as JAX's.
    for f in ("rvecs", "points", "pt_desc"):
        assert getattr(m, f).shape == np.asarray(getattr(jmap, f)).shape
    assert m.obs.uv.shape == np.asarray(jmap.obs.uv).shape == (3 * W * B, 2)
    assert traj.rvecs.shape == (N_FRAMES, 3)
    np.testing.assert_allclose(traj.rvecs.numpy(), np.asarray(jt.rvecs), atol=RUN_R_ATOL)
    np.testing.assert_allclose(traj.tvecs.numpy(), np.asarray(jt.tvecs),
                               atol=RUN_T_RTOL * np.abs(np.asarray(jt.tvecs)).max())
    n_got, n_want = int(m.pt_valid.sum()), int(jmap.pt_valid.sum())
    assert abs(n_got - n_want) <= 0.03 * n_want
    # ATE after Sim(3) alignment: under 1% of the span, within 1e-3 of JAX's,
    # and the loops improve on the windowed-only run.
    ate, span = _ate(traj, rv, tv)
    want_ate, _ = _ate(todo.Trajectory(*(torch.from_numpy(np.array(a)) for a in jt)), rv, tv)
    assert ate < 0.01 * span and abs(ate - want_ate) < 1e-3
    assert ate < _ate(w_traj, rv, tv)[0]


@pytest.mark.parametrize("sim3", [True, False])
def test_correct_trajectory_matches_jax(runs, sim3):
    """The end-of-run correction on the same frozen trajectory and loops:
    the packages' pose graphs agree to 1e-5 (the dense solvers at 14 nodes)."""
    _want, (traj, _m, info), (w_traj, _wm) = runs
    frames = info["loop_frames"]
    rng = np.random.default_rng(2)
    loops_t = [todo.ArchiveLoop(w_traj.rvecs[f] + 0.01, w_traj.tvecs[f] * 0.97,
                                torch.tensor(50, dtype=torch.int32),
                                torch.tensor(int(rng.integers(0, f)), dtype=torch.int32))
               for f in frames]
    loops_j = [jodo.ArchiveLoop(jnp.asarray(p.rvec.numpy()), jnp.asarray(p.tvec.numpy()),
                                jnp.int32(50), jnp.int32(int(p.birth))) for p in loops_t]
    got = todo.correct_trajectory(w_traj, frames, loops_t, sim3=sim3)
    want = jodo.correct_trajectory(jodo.Trajectory(jnp.asarray(w_traj.rvecs.numpy()),
                                                   jnp.asarray(w_traj.tvecs.numpy())),
                                   frames, loops_j, sim3=sim3)
    np.testing.assert_allclose(got.rvecs.numpy(), np.asarray(want.rvecs), atol=1e-5)
    np.testing.assert_allclose(got.tvecs.numpy(), np.asarray(want.tvecs), atol=1e-5)


def _seeded_sampler(kind, frame, valid, n_hyp, n_pts):
    """Draws that depend on (kind, frame) alone, so a resumed run draws what
    the uninterrupted one drew."""
    g = torch.Generator().manual_seed(1000 * ("init", "pnp", "loop").index(kind) + frame)
    u = torch.rand(n_hyp * n_pts, generator=g)
    return todo.uniform_draws(u)(valid, n_hyp, n_pts)


def test_checkpoint_resume_equals_uninterrupted_run(scene, tmp_path):
    """A run checkpointed every 3 frames, cut after frame 8 and resumed,
    gives the uninterrupted run bit for bit (the checkpoint holds the whole
    carry: map, used mask, anchors, archive, loop buffer, frozen poses); the
    fingerprint refuses another window."""
    feats = [tfe.features_from_numpy(f, "cpu") for f in scene[0][:11]]
    kw = dict(RUN_KW, loop_closure=True, archive_policy="coverage", return_info=True,
              sampler=_seeded_sampler)
    full, m_full, info_full = todo.run_odometry(None, feats, K_T, **kw)
    d = tmp_path / "ck"
    todo.run_odometry(None, feats[:9], K_T, checkpoint_dir=str(d), checkpoint_every=3,
                      max_loops=8, **kw)
    assert tckpt.latest_step(d) == 6
    resumed, m_res, info_res = todo.run_odometry(None, feats, K_T, checkpoint_dir=str(d),
                                                 checkpoint_every=3, max_loops=8, **kw)
    assert tckpt.latest_step(d) == 9
    assert info_res["loop_frames"] == info_full["loop_frames"]
    assert torch.equal(resumed.rvecs, full.rvecs) and torch.equal(resumed.tvecs, full.tvecs)
    assert all(torch.equal(a, b) for a, b in zip(m_res[:-1], m_full[:-1]))
    with pytest.raises(ValueError, match="fingerprint mismatch.*window"):
        todo.run_odometry(None, feats, K_T, checkpoint_dir=str(d), checkpoint_every=3,
                          max_loops=8, **dict(kw, window=5))


def test_run_odometry_argument_checks(scene):
    feats = [tfe.features_from_numpy(f, "cpu") for f in scene[0][:3]]
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="window must be >= 3"):
        todo.run_odometry(gen, feats, K_T, window=2)
    with pytest.raises(ValueError, match="Generator or a sampler"):
        todo.run_odometry(None, feats, K_T)
    with pytest.raises(ValueError, match="archive_policy"):
        todo.run_odometry(gen, feats, K_T, loop_closure=True, archive_policy="lru")
    with pytest.raises(ValueError, match="multiple of pts_per_frame"):
        todo.run_odometry(gen, feats, K_T, loop_closure=True, archive_policy="coverage",
                          archive_size=100, pts_per_frame=64)
    with pytest.raises(ValueError, match="sampler is a host callback"):
        todo.run_odometry(None, feats, K_T, sampler=_seeded_sampler, graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        todo.run_odometry(gen, [tfe.features_from_numpy(f, "cpu") for f in scene[0][:6]],
                          K_T, window=4, pts_per_frame=B, graph=True)
    # Short sequences: no steady step, the window frames come back.
    traj, m = todo.run_odometry(gen, feats, K_T, window=4, pts_per_frame=B)
    assert traj.rvecs.shape == (3, 3) and m.rvecs.shape == (4, 3)


def test_cli_sfm_window_loop_closure_on_cpu(capsys, tmp_path):
    """``cli sfm --window 4 --loop-closure --device cpu`` renders frames,
    runs the frontend and run_odometry with loop closure, and reports the
    live landmarks, the RMS and the ATE; ``--archive-policy`` without
    ``--loop-closure`` is refused, as in the JAX CLI."""
    from sift_parallel_optimization_tpu_torch.utils import native

    assert native._load() is not None, native._build_error
    traj = tmp_path / "traj.txt"
    rc = tcli.main(["sfm", "--device", "cpu", "--frames", "7", "--size", "160", "--window", "4",
                    "--loop-closure", "--archive-policy", "coverage",
                    "--save-traj", str(traj)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "window odometry (W=4, loop closure): 7 frames" in out and "live landmarks" in out
    assert "reprojection RMS:" in out
    ate = float(out.split("ATE (Sim3-aligned): ")[1].split()[0])
    span = float(out.split("trajectory span ")[1].split(")")[0])
    assert ate < 0.1 * span, out
    assert len([ln for ln in traj.read_text().splitlines() if not ln.startswith("#")]) == 7
    assert tcli.main(["sfm", "--device", "cpu", "--window", "4",
                      "--archive-policy", "coverage"]) == 2
    assert "--archive-policy requires --window and --loop-closure" in capsys.readouterr().out
