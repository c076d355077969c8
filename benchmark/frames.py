"""Camera frames rendered from a seed: the benchmark's traffic source.

:func:`render_view` is a frozen copy of the port's NumPy pinhole renderer
(``utils/native._render_frame_numpy``), generalised to H x W frames, any
intrinsics and any scene box: a cloud of 3-D Gaussian blobs seen by a
pinhole camera, plus uniform noise, clipped to [0, 1]. It takes its random
draws as arrays, so the copy is held to the original on the original's own
draws (``benchmark/tests``), while :func:`render_pool` feeds it from NumPy's
PCG64, which is vectorised (the original's xorshift64* loop in Python takes
about a second for one frame of KITTI's size).

:func:`render_pool` renders a moving camera's consecutive views of one
scene, every draw from the seed: the same seed gives the same frames.
"""

from __future__ import annotations

import math

import numpy as np

# The draws of one blob: X, Y, Z, world sigma, amplitude (uniforms in [0, 1)).
BLOB_DRAWS = 5


def rotation(rvec) -> np.ndarray:
    """f32 rotation matrix of an axis-angle vector (Rodrigues), as the
    original renderer forms it."""
    f32 = np.float32
    rv = np.asarray(rvec, f32)
    th = np.sqrt(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2])
    R = np.eye(3, dtype=f32)
    if th > f32(1e-8):
        kx, ky, kz = rv[0] / th, rv[1] / th, rv[2] / th
        c, s, v = np.cos(th), np.sin(th), f32(1.0) - np.cos(th)
        R = np.array([[c + kx * kx * v, kx * ky * v - kz * s, kx * kz * v + ky * s],
                      [ky * kx * v + kz * s, c + ky * ky * v, ky * kz * v - kx * s],
                      [kz * kx * v - ky * s, kz * ky * v + kx * s, c + kz * kz * v]], f32)
    return R


def render_view(height: int, width: int, rvec, tvec, camera: dict, scene: dict,
                blob_draws: np.ndarray, noise_draws: np.ndarray) -> np.ndarray:
    """(height, width) f32 frame: the blobs of ``blob_draws`` ((N * 5,)
    uniforms) seen from pose (``rvec``, ``tvec``), plus ``noise_draws``
    ((height * width,) uniforms) scaled by the scene's noise.

    ``camera``: fx, fy, cx, cy. ``scene``: background, x_span, y_span,
    z_near, z_depth, wsig_min, wsig_span, amp_span, noise, min_sigma_px.
    With the original's scene and fx = fy = f, cx = cy = size / 2 this is
    the original renderer to float rounding: each blob's footprint is the
    product of its row and column Gaussians (the original takes one
    exponential of their sum), and the footprints are summed in float64,
    vectorised over the blobs of one window size, where the original adds
    them one by one in float32."""
    f32 = np.float32
    R = rotation(rvec)
    tv = np.asarray(tvec, f32)
    out = np.full((height, width), f32(scene["background"]), f32)
    fx, fy = f32(camera["fx"]), f32(camera["fy"])
    cx, cy = f32(camera["cx"]), f32(camera["cy"])
    xs, ys = f32(scene["x_span"]), f32(scene["y_span"])
    zn, zd = f32(scene["z_near"]), f32(scene["z_depth"])
    w0, ws = f32(scene["wsig_min"]), f32(scene["wsig_span"])
    amp_span, min_sig = f32(scene["amp_span"]), f32(scene["min_sigma_px"])
    half = f32(0.5)
    d = np.asarray(blob_draws, f32).reshape(-1, BLOB_DRAWS)
    X, Y = (d[:, 0] - half) * xs, (d[:, 1] - half) * ys
    Z, wsig = zn + d[:, 2] * zd, w0 + d[:, 3] * ws
    amp = (d[:, 4] - half) * amp_span
    xc = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + tv[0]
    yc = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + tv[1]
    zc = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + tv[2]
    front = zc >= half
    zs = np.where(front, zc, f32(1.0))
    u = fx * xc / zs + cx
    v = fy * yc / zs + cy
    sig = np.maximum(fx * wsig / zs, min_sig)
    r = (f32(3.0) * sig).astype(np.int64) + 1
    seen = front & ~((u + r < 0) | (u - r >= width) | (v + r < 0) | (v - r >= height))
    acc = np.zeros(height * width, np.float64)
    for rad in np.unique(r[seen]):
        b = np.flatnonzero(seen & (r == rad))
        ub, vb, sb, ab = u[b, None], v[b, None], sig[b, None], amp[b, None, None]
        off = np.arange(-rad, rad + 1)
        iy = vb.astype(np.int64) + off                      # (n, 2r + 1) window rows
        ix = ub.astype(np.int64) + off
        inv = f32(1.0) / (f32(2.0) * sb * sb)
        ey = np.exp(-((iy.astype(f32) - vb) ** 2) * inv)    # exp(-(dx2 + dy2) inv), split
        ex = np.exp(-((ix.astype(f32) - ub) ** 2) * inv)
        ey *= ((iy >= 0) & (iy < height)) * ab[:, :, 0]
        ex *= (ix >= 0) & (ix < width)
        val = ey[:, :, None] * ex[:, None, :]
        flat = (iy.clip(0, height - 1) * width)[:, :, None] + ix.clip(0, width - 1)[:, None, :]
        acc += np.bincount(flat.ravel(), weights=val.ravel(), minlength=height * width)
    out += acc.reshape(height, width).astype(f32)
    out += f32(scene["noise"]) * (noise_draws.reshape(height, width) - half)
    return np.clip(out, f32(0.0), f32(1.0))


def camera_pose(i: int, motion: dict, phase: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(rvec, tvec) of frame ``i`` of a smooth path: forward by
    ``forward`` a frame, a sideways and vertical sway, and a yaw / pitch
    sway (radians), each sway of period ``period`` frames, started
    ``phase`` frames into its period."""
    ph = 2.0 * math.pi * (i + phase) / motion["period"]
    rvec = np.array([motion["pitch"] * math.sin(0.5 * ph), motion["yaw"] * math.sin(ph), 0.0],
                    np.float32)
    tvec = np.array([motion["sway_x"] * math.sin(ph), motion["sway_y"] * math.cos(ph),
                     -motion["forward"] * i], np.float32)
    return rvec, tvec


def pool_size(height: int, width: int, pool_mb: float, multiple: int) -> int:
    """Frames in a pool of at least ``pool_mb`` MiB of f32 frames, rounded
    up to a multiple of ``multiple`` (the mix's batch)."""
    n = math.ceil(pool_mb * 2**20 / (4.0 * height * width))
    return -(-n // multiple) * multiple


def render_pool(cfg: dict, n_frames: int, seed: int) -> np.ndarray:
    """(n_frames, H, W) f32: consecutive views of one scene along the
    configuration's camera path, the scene, the path's phase and every
    frame's noise drawn from ``seed``."""
    h, w = cfg["height"], cfg["width"]
    scene, motion = cfg["scene"], cfg["motion"]
    rng = np.random.Generator(np.random.PCG64(seed))
    blobs = rng.random(BLOB_DRAWS * scene["blobs"], dtype=np.float32)
    phase = int(rng.integers(0, motion["period"]))
    out = np.empty((n_frames, h, w), np.float32)
    for i in range(n_frames):
        rvec, tvec = camera_pose(i, motion, phase)
        noise = rng.random(h * w, dtype=np.float32)
        out[i] = render_view(h, w, rvec, tvec, cfg["camera"], scene, blobs, noise)
    return out
