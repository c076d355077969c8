"""The port's online odometry (``models/odometry.OdometryStream``) on the CPU:
against the port's own ``run_odometry`` bit for bit on the same features and
draws, against the JAX package's ``OdometryStream`` with JAX's draws
replayed, on streams shorter than the window, and its push contract (a
returned pose is the caller's; a frame of another capacity is refused).

The scene is tests/test_torch_odometry.py's synthetic out-and-back, cut to
13 frames so that (n - 1) % ba_every == 0: run_odometry runs a window BA
on its last frame because it knows the length, and the stream, which does
not, runs one in ``finish`` only when its last frame ran none. The steady
step runs eagerly here (``graph=False`` on the CPU); ``chip_smoke.py``
holds the stream's captured step against ``run_odometry`` on the card.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_odometry import (
    CAPACITY,
    K_J,
    K_NP,
    K_T,
    N_PTS,
    RUN_KW,
    RUN_R_ATOL,
    RUN_T_RTOL,
    STEP,
    W,
    _jax_features,
    jax_sampler,
)

from sift_parallel_optimization_tpu.models import odometry as jodo
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models import odometry as todo
from sift_parallel_optimization_tpu_torch.utils import synthetic

N_STREAM = 13  # (13 - 1) % 2 == 0: the last frame's BA lines up


@pytest.fixture(scope="module")
def scene13():
    """tests/test_torch_odometry.py's scene (same seed, landmarks and path),
    its first N_STREAM frames as the port's CPU features and as numpy."""
    rng = np.random.default_rng(0)
    pts, descs = synthetic.landmarks(rng, N_PTS, lo=(-5, -3, 6), hi=(12, 3, 12))
    rv, tv = synthetic.out_and_back(14, step=STEP)
    arrays = [synthetic.view_features(rng, pts, descs, rv[i], tv[i], K_NP, 400, 300, CAPACITY)
              for i in range(14)][:N_STREAM]
    return arrays, [tfe.features_from_numpy(a, "cpu") for a in arrays]


def _stream(feats, gen=None, sampler=None, **kw):
    s = todo.OdometryStream(gen, K_T, sampler=sampler, **dict(RUN_KW, **kw))
    poses = [s.push(f) for f in feats]
    return poses, s.finish()


@pytest.mark.parametrize("loop_closure", [True, False])
def test_stream_equals_run_odometry_bitwise(scene13, loop_closure):
    """The same generator seed through run_odometry and the stream (the same
    max_loops): trajectories, window maps and loops bit for bit."""
    _arrays, feats = scene13
    want, m_want, info_want = todo.run_odometry(
        torch.Generator().manual_seed(7), feats, K_T, loop_closure=loop_closure, max_loops=64,
        return_info=True, **RUN_KW)
    poses, (traj, m, info) = _stream(feats, torch.Generator().manual_seed(7),
                                     loop_closure=loop_closure)
    assert torch.equal(traj.rvecs, want.rvecs) and torch.equal(traj.tvecs, want.tvecs)
    assert all(torch.equal(a, b) for a, b in zip(m[:-1], m_want[:-1]))
    assert info["loop_frames"] == info_want["loop_frames"]
    assert info["loop_inliers"] == info_want["loop_inliers"]
    assert info["loops_dropped"] == 0 and info["graph_replays"] == 0
    if loop_closure:
        assert info["loop_frames"], "the scene closes a loop"
    # A steady push returns slot W-1 of the window after that frame's step:
    # the newest frame's pose before the end-of-run correction.
    assert len(poses) == N_STREAM and poses[0][0].shape == (3,)
    assert all(bool(torch.isfinite(r).all() & torch.isfinite(t).all()) for r, t in poses)


def test_stream_matches_jax_stream_with_replayed_draws(scene13):
    """JAX's OdometryStream and the port's with JAX's draws replayed, loop
    closure on: the same loop frames, poses within test_torch_odometry.py's
    run tolerances."""
    arrays, feats = scene13
    key = jax.random.key(0)
    js = jodo.OdometryStream(key, K_J, loop_closure=True, **RUN_KW)
    for a in arrays:
        js.push(_jax_features(a))
    jt, jm, jinfo = js.finish()
    _poses, (traj, m, info) = _stream(feats, sampler=jax_sampler(key), loop_closure=True)
    assert info["loop_frames"] and info["loop_frames"] == jinfo["loop_frames"]
    assert info["loops_dropped"] == jinfo["loops_dropped"] == 0
    assert traj.rvecs.shape == (N_STREAM, 3) and m.rvecs.shape == np.asarray(jm.rvecs).shape
    np.testing.assert_allclose(traj.rvecs.numpy(), np.asarray(jt.rvecs), atol=RUN_R_ATOL)
    np.testing.assert_allclose(traj.tvecs.numpy(), np.asarray(jt.tvecs),
                               atol=RUN_T_RTOL * np.abs(np.asarray(jt.tvecs)).max())


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_stream_short_sequences(scene13, n):
    """Below the window (JAX's test_odometry_stream_short_sequences): 1
    frame (the identity pose), 2 (the bootstrap pair), 3 and 4 (filling).
    From 3 frames on it is run_odometry's result bit for bit; at 2 the
    stream runs the final BA that run_odometry skips for a pair."""
    feats = scene13[1][:n]
    _poses, (traj, m, info) = _stream(feats, torch.Generator().manual_seed(3), window=5)
    assert traj.rvecs.shape == (n, 3) and m.rvecs.shape == (5, 3)
    assert bool(torch.isfinite(traj.tvecs).all()) and info["loops_dropped"] == 0
    if n == 1:
        assert not bool(traj.rvecs.any()) and not bool(traj.tvecs.any())
    if n >= 3:
        want, _m = todo.run_odometry(torch.Generator().manual_seed(3), feats, K_T,
                                     **dict(RUN_KW, window=5))
        assert torch.equal(traj.rvecs, want.rvecs) and torch.equal(traj.tvecs, want.tvecs)


def test_pushed_pose_is_not_overwritten_and_capacity_is_fixed(scene13):
    """A pose returned by push keeps its value through the next pushes (the
    runner's buffers are overwritten every frame); a frame of another
    feature capacity raises."""
    feats = scene13[1]
    s = todo.OdometryStream(torch.Generator().manual_seed(1), K_T, **RUN_KW)
    kept = []
    for f in feats[:W + 3]:
        r, t = s.push(f)
        kept.append((r, t, r.clone(), t.clone()))
    assert s.runner is not None and s.frames == W + 3
    assert all(torch.equal(r, r0) and torch.equal(t, t0) for r, t, r0, t0 in kept)
    # The last two steady pushes returned different poses: not one buffer.
    assert not torch.equal(kept[-1][0], kept[-2][0])
    small = tfe.Features(tfe.Keypoints(*(a[:CAPACITY // 2] for a in feats[0].keypoints)),
                         feats[0].descriptors[:CAPACITY // 2])
    with pytest.raises(ValueError, match="capacity"):
        s.push(small)
    with pytest.raises(ValueError, match="capacity"):
        s.runner.feed(W + 3, small)


def test_stream_argument_checks():
    with pytest.raises(ValueError, match="window must be >= 3"):
        todo.OdometryStream(torch.Generator(), K_T, window=2)
    with pytest.raises(ValueError, match="Generator or a sampler"):
        todo.OdometryStream(None, K_T)
    with pytest.raises(ValueError, match="sampler is a host callback"):
        todo.OdometryStream(None, K_T, sampler=lambda *a: None, graph=True)
    with pytest.raises(ValueError, match="archive_policy"):
        todo.OdometryStream(torch.Generator(), K_T, loop_closure=True, archive_policy="lru")
    with pytest.raises(ValueError, match="CUDA device"):
        todo.OdometryStream(torch.Generator(), K_T, graph=True)


def test_steady_push_returns_the_newest_window_slot(scene13):
    """A steady push returns slot W-1 of the window (the newest frame), as
    the JAX stream does, as a copy of the runner's buffer."""
    feats = scene13[1][:W + 2]
    s = todo.OdometryStream(torch.Generator().manual_seed(2), K_T, **RUN_KW)
    for f in feats:
        r, t = s.push(f)
    m = s.runner.carry.m
    assert torch.equal(r, m.rvecs[W - 1]) and torch.equal(t, m.tvecs[W - 1])
    assert r.data_ptr() != m.rvecs[W - 1].data_ptr()


@pytest.mark.parametrize("window", [0, 4])
def test_cli_stream_on_cpu(capsys, window):
    """``cli stream --device cpu`` at 128^2 for 10 frames: frames from the
    host library's ring loader through the frontend (and with a window
    through OdometryStream); the keypoints a frame are those of the
    port's frontend on the same synth_frame frames (1..10, after the
    warm-up frame 0), and with a window every frame has a finite pose."""
    from sift_parallel_optimization_tpu_torch import cli as tcli
    from sift_parallel_optimization_tpu_torch.utils import native

    assert native.available(), native.build_error()
    argv = ["stream", "--device", "cpu", "--frames", "10", "--size", "128"]
    rc = tcli.main(argv + (["--window", str(window)] if window else []))
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "10 frames in " in out and "ms/frame end-to-end pipelined" in out
    fe = tfe.SiftFrontend(tfe.sift_config(128), max_keypoints=512,
                          dual_orientation=bool(window), device="cpu")
    n_kp = sum(int(fe(torch.from_numpy(native.synth_frame(128, i, seed=0))).keypoints.count())
               for i in range(1, 11))
    assert f"; {n_kp / 10:.0f} keypoints/frame" in out, out
    if window:
        assert "online odometry (W=4): 10 poses, 0 loops, extent [" in out, out
        extent = [float(v) for v in out.split("extent [")[1].split("]")[0].split(",")]
        assert len(extent) == 3 and all(np.isfinite(extent)), out
    else:
        assert "online odometry" not in out


def test_serve_stream_pushes_every_timed_frame():
    """The serving loop's return: the stream has every timed frame (not the
    warm-up) and a trajectory of as many poses."""
    from sift_parallel_optimization_tpu_torch import cli as tcli

    res = tcli.serve_stream(6, 96, max_keypoints=128, window=3, device="cpu")
    assert res["frames"] == 6 and res["seconds"] > 0 and res["stream"].frames == 6
    traj, m, _info = res["stream"].finish()
    assert traj.rvecs.shape == (6, 3) and m.rvecs.shape == (3, 3)
