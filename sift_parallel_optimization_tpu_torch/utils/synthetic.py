"""Synthetic SfM scenes: features of cameras looking at a seeded point cloud.

The features are built as the JAX package's SfM tests build them: one unit
random 128-d descriptor per landmark shared by every view (plus noise), the
landmark's projection (plus pixel noise) as the keypoint, valid where the
landmark is in front of the camera and inside the image. They isolate
matching, PnP, triangulation, BA and loop closure from the image frontend.
Everything is numpy, made from the caller's generator.
"""

from __future__ import annotations

import numpy as np


def rodrigues_np(w) -> np.ndarray:
    """(3,) axis-angle -> (3, 3) rotation matrix, in float64."""
    theta = float(np.linalg.norm(w))
    if theta < 1e-12:
        return np.eye(3)
    k = np.asarray(w, np.float64) / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def landmarks(rng, n: int, lo=(-3, -3, 6), hi=(3, 3, 12)):
    """(n, 3) f32 points uniform in the box [lo, hi] and (n, 128) f32 unit
    descriptors."""
    pts = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    descs = rng.normal(size=(n, 128)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    return pts, descs


def view_features(rng, pts, descs, rvec, tvec, K, width, height, capacity,
                  px_noise=0.2, desc_noise=0.03, compact=False) -> dict:
    """Features of one camera (world->cam pose ``rvec``, ``tvec``) as a dict
    of numpy arrays in the layout of ``models/frontend.features_from_numpy``.

    By default slot i is landmark i (padding slots invalid up to
    ``capacity``). With ``compact``, the landmarks the camera sees fill the
    slots in a random order -- a random ``capacity`` of them where it sees
    more -- so a world may hold more landmarks than a frame has slots."""
    n = pts.shape[0]
    pc = pts.astype(np.float64) @ rodrigues_np(rvec).T + np.asarray(tvec, np.float64)
    z = pc[:, 2]
    uv = (pc / np.where(np.abs(z) > 1e-9, z, 1e-9)[:, None]) @ np.asarray(K, np.float64).T
    uv = uv[:, :2].astype(np.float32) + rng.normal(size=(n, 2)).astype(np.float32) * px_noise
    vis = ((z > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < width - 5)
           & (uv[:, 1] > 5) & (uv[:, 1] < height - 5))
    d = descs + rng.normal(size=descs.shape).astype(np.float32) * desc_noise
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if compact:
        seen = np.flatnonzero(vis)
        if len(seen) > capacity:
            seen = rng.choice(seen, capacity, replace=False)
        seen = rng.permutation(seen)
        uv, d, vis = uv[seen], d[seen], np.ones(len(seen), bool)
        n = len(seen)
    elif capacity < n:
        raise ValueError(f"capacity {capacity} < {n} landmarks")
    pad = capacity - n
    p = lambda a: np.pad(a, (0, pad))
    return {
        "keypoints": {
            "x": p(uv[:, 0]), "y": p(uv[:, 1]),
            "sigma": p(np.full(n, 2.0, np.float32)), "score": p(np.ones(n, np.float32)),
            "orientation": np.zeros(capacity, np.float32),
            "octave": np.zeros(capacity, np.int32), "scale": np.ones(capacity, np.int32),
            "valid": p(vis),
        },
        "descriptors": np.pad(d, ((0, pad), (0, 0))).astype(np.float32),
    }


def out_and_back(n_frames: int, step=(-0.35, 0.02, 0.05), yaw: float = 0.05, past: int = 0):
    """(n, 3) rvecs and (n, 3) tvecs, f32, of a camera that moves out along
    ``step`` (turning by ``yaw`` a step) and comes back the same way: frame i
    sits at step count i up to the turn, then counts down, ending ``past``
    steps beyond its start (n - 1 - past even; with past = 0, frame i sits
    at min(i, n - 1 - i)). A revisit that a loop closure can find."""
    turn = (n_frames - 1 - past) // 2
    pos = np.array([i if i <= turn else 2 * turn - i for i in range(n_frames)], np.float32)
    rvecs = np.stack([[0.0, yaw * k, 0.0] for k in pos]).astype(np.float32)
    tvecs = (pos[:, None] * np.asarray(step, np.float32)).astype(np.float32)
    return rvecs, tvecs


def camera_centers_np(rvecs, tvecs) -> np.ndarray:
    """(C, 3) camera centers c = -R^T t of world->cam poses, float64."""
    return np.stack([-rodrigues_np(r).T @ np.asarray(t, np.float64)
                     for r, t in zip(rvecs, tvecs)])
