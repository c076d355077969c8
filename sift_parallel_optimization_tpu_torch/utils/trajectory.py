"""Trajectory alignment + ATE metrics (port of ``utils/trajectory.py``).

ATE (absolute trajectory error) is computed after Umeyama Sim(3) alignment,
the standard protocol for monocular pipelines whose scale is unobservable
(TUM/KITTI-style evaluation). The file formats are read and written with
numpy on the host; the alignment runs on the tensors' device.

``torch.linalg.svd`` may return other signs of U and V than XLA's SVD; the
alignment (s, R, t) it yields is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from sift_parallel_optimization_tpu_torch.models.geometry import _det3, rodrigues
from sift_parallel_optimization_tpu_torch.utils.device import f32_precision, resolve_device


def camera_centers(rvecs: torch.Tensor, tvecs: torch.Tensor) -> torch.Tensor:
    """(C, 3) camera centers from world->cam poses: c = -R^T t."""
    return -torch.einsum("cij,ci->cj", rodrigues(rvecs), tvecs)


@f32_precision
def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True):
    """Least-squares similarity transform: s * R @ src + t ~= dst.

    (N, 3) point sets. Returns (s, R, t) as tensors. Umeyama 1991 closed form.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]            # (3, 3)
    u, d, vt = torch.linalg.svd(cov)
    sgn = torch.sign(_det3(u) * _det3(vt))
    one = torch.ones_like(sgn)
    diag = torch.stack([one, one, sgn])
    R = (u * diag[None, :]) @ vt
    var_s = (xs * xs).sum() / src.shape[0]
    s = (d * diag).sum() / torch.clamp(var_s, min=1e-12) if with_scale else one
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def ate_rmse(
    est_centers: torch.Tensor, gt_centers: torch.Tensor, with_scale: bool = True
) -> torch.Tensor:
    """RMSE of aligned camera centers (the headline ATE number)."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = s * est_centers @ R.T + t
    return torch.sqrt(((aligned - gt_centers) ** 2).sum(-1).mean())


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cam_to_world(rvecs, tvecs):
    """(C, 3, 3) camera-to-world rotations and (C, 3) centers (numpy) of
    world->cam axis-angle poses, the rotations in fp32 as the port computes
    them."""
    R = rodrigues(torch.as_tensor(_host(rvecs), dtype=torch.float32)).numpy()
    t = _host(tvecs)
    return np.swapaxes(R, 1, 2), -np.einsum("cij,ci->cj", R, t)


# ---------------------------------------------------------------------------
# TUM-RGB(D) trajectory format
# ---------------------------------------------------------------------------
#
# One pose per line: ``timestamp tx ty tz qx qy qz qw`` ('#' comments),
# poses camera-to-world -- the interchange format of the TUM RGB-D benchmark
# tooling.


def load_tum(path):
    """Read a TUM trajectory file.

    Returns (timestamps (N,), centers (N, 3), quats (N, 4) xyzw) as numpy
    arrays. Camera-to-world convention: the translation IS the camera center.
    """
    ts, rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                raise IOError(f"{path}: bad TUM line {line!r}")
            vals = [float(p) for p in parts[:8]]
            ts.append(vals[0])
            rows.append(vals[1:])
    if not rows:
        raise IOError(f"{path}: no poses")
    arr = np.asarray(rows, np.float64)
    return np.asarray(ts), arr[:, :3].astype(np.float32), arr[:, 3:7].astype(np.float32)


def save_tum(path, timestamps, rvecs, tvecs) -> None:
    """Write world->cam axis-angle poses (tensors or arrays) as a TUM
    (cam-to-world) file."""
    r_wc, centers = _cam_to_world(rvecs, tvecs)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i, ts in enumerate(timestamps):
            q = _rotmat_to_quat(r_wc[i])
            c = centers[i]
            f.write(
                f"{float(ts):.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


# ---------------------------------------------------------------------------
# KITTI odometry trajectory format
# ---------------------------------------------------------------------------
#
# One pose per line: 12 floats, the row-major 3x4 [R | t] camera-to-world
# matrix of frame i (no timestamps -- KITTI poses are frame-indexed).


def load_kitti(path):
    """Read a KITTI odometry poses file.

    Returns (centers (N, 3) f32, rotations (N, 3, 3) f32 camera-to-world) as
    numpy arrays; the translation column IS the camera center.
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 12:
                raise IOError(f"{path}: bad KITTI line {line!r}")
            rows.append([float(p) for p in parts])
    if not rows:
        raise IOError(f"{path}: no poses")
    m = np.asarray(rows, np.float64).reshape(-1, 3, 4)
    return m[:, :, 3].astype(np.float32), m[:, :, :3].astype(np.float32)


def save_kitti(path, rvecs, tvecs) -> None:
    """Write world->cam axis-angle poses as a KITTI poses file
    (camera-to-world 3x4 per line, frame order)."""
    r_wc, centers = _cam_to_world(rvecs, tvecs)
    with open(path, "w") as f:
        for i in range(len(centers)):
            m = np.concatenate([r_wc[i], centers[i][:, None]], axis=1)
            f.write(" ".join(f"{v:.9f}" for v in m.reshape(-1)) + "\n")


def _rotmat_to_quat(R):
    """(3, 3) rotation -> (x, y, z, w) quaternion (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / max(s, 1e-12)
        q[j] = (R[j, i] + R[i, j]) / max(s, 1e-12)
        q[k] = (R[k, i] + R[i, k]) / max(s, 1e-12)
        x, y, z, w = q
    return np.asarray([x, y, z, w], np.float32)


def quat_to_rotmat(q, device=None) -> torch.Tensor:
    """(N, 4) xyzw quaternions -> (N, 3, 3) rotations (batched). A tensor is
    followed to its device; an array goes to ``device`` (None means the card,
    and raises without one)."""
    device = resolve_device(device, like=q)
    q = torch.as_tensor(_host(q), dtype=torch.float32).to(device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def associate(ts_a, ts_b, max_dt: float = 0.02):
    """Nearest-timestamp association (the TUM evaluation protocol).

    Returns (idx_a, idx_b) integer arrays of matched pairs: for each a, the
    closest b within ``max_dt`` seconds, each b used at most once.
    """
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    order = np.argsort(ts_b)
    tb = ts_b[order]
    ia, ib = [], []
    used = set()
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(tb, t))
        best, best_dt = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(tb) and jj not in used:
                dt = abs(tb[jj] - t)
                if dt <= best_dt:
                    best, best_dt = jj, dt
        if best >= 0:
            used.add(best)
            ia.append(i)
            ib.append(int(order[best]))
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)
