"""How much the long-sequence odometry gates depend on the RANSAC draws, on
the CPU, for the JAX package and the PyTorch port side by side.

tests/test_long_sequence.py gates one run (``jax.random.key(1)``) of the
120-frame three-cycle revisit: FIFO loop closure under 5% of the span and
1.8x better than windowed-only; the coverage policy on an 8-block archive
under 1.2% of the span. This script runs the same configuration (256^2
frames, W=6, 128 landmarks a frame, the JAX frontend's 256 keypoints with
dual orientations) for several draw seeds through

* the JAX package's ``run_odometry`` with ``key(seed)``,
* the port's ``run_odometry`` with the JAX key chain's draws replayed
  (``sampler``), on the same features,
* the port's ``run_odometry`` with ``torch.Generator().manual_seed(seed)``,

and prints, per run, the accepted loops and the ATE (Sim(3)-aligned, % of
the span). Both packages import here, as in the tests; nothing is written.

    python tools/odometry_draw_spread.py --seeds 1,2,3,4 [--sides jax,replay,port]

Each run takes a few minutes on the CPU (54 runs for 6 seeds).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sift_parallel_optimization_tpu.models import matching as jm  # noqa: E402
from sift_parallel_optimization_tpu.models import odometry as jodo  # noqa: E402
from sift_parallel_optimization_tpu.models.frontend import (  # noqa: E402
    extract_features,
    sift_config,
)
from sift_parallel_optimization_tpu.utils import native as jnative  # noqa: E402
from sift_parallel_optimization_tpu_torch.models import frontend as tfe  # noqa: E402
from sift_parallel_optimization_tpu_torch.models import odometry as todo  # noqa: E402
from sift_parallel_optimization_tpu_torch.utils import trajectory as ttraj  # noqa: E402

N, PERIOD, SIZE, WINDOW = 120, 40, 256, 6
CONFIGS = {
    "windowed": {},
    "fifo": dict(loop_closure=True),
    "coverage": dict(loop_closure=True, archive_size=8 * 128, archive_policy="coverage"),
}


def sequence():
    """tests/test_long_sequence.py's frames and truth, through the JAX frontend."""
    half = PERIOD // 2
    ks = [(i % PERIOD) if (i % PERIOD) <= half else PERIOD - (i % PERIOD) for i in range(N)]
    gt_r = np.stack([[0.0, 0.025 * k, 0.002 * k] for k in ks]).astype(np.float32)
    gt_t = np.stack([[-0.25 * k, 0.012 * k, 0.035 * k] for k in ks]).astype(np.float32)
    cfg = sift_config(SIZE)
    fe = jax.jit(lambda x: extract_features(x, cfg, 256, dual_orientation=True))
    feats = [fe(jnp.asarray(jnative.render_frame(SIZE, gt_r[i], gt_t[i], float(SIZE), seed=3)))
             for i in range(N)]
    return feats, gt_r, gt_t


def jax_sampler(key):
    """The JAX run's draws for the port's ``sampler``."""
    draw = jax.jit(jm._sample_indices, static_argnums=(2, 3))
    loop_base = jax.random.fold_in(key, 11)

    def sample(kind, frame, valid, n_hyp, n_pts):
        k = {"init": lambda: jax.random.fold_in(key, 0),
             "pnp": lambda: jax.random.split(jax.random.fold_in(key, frame))[0],
             "loop": lambda: jax.random.fold_in(loop_base, frame)}[kind]()
        return np.array(draw(k, jnp.asarray(valid.numpy()), n_hyp, n_pts))

    return sample


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="1,2,3,4")
    p.add_argument("--sides", default="jax,replay,port")
    args = p.parse_args(argv)
    feats, gt_r, gt_t = sequence()
    t_feats = [tfe.features_from_numpy(
        {"keypoints": {k: np.asarray(v) for k, v in f.keypoints._asdict().items()},
         "descriptors": np.asarray(f.descriptors)}, "cpu") for f in feats]
    K = np.array([[SIZE, 0, SIZE / 2], [0, SIZE, SIZE / 2], [0, 0, 1.0]], np.float32)
    gt = ttraj.camera_centers(torch.from_numpy(gt_r), torch.from_numpy(gt_t))
    span = float(np.linalg.norm(np.ptp(gt.numpy(), axis=0)))
    for seed in map(int, args.seeds.split(",")):
        for side in args.sides.split(","):
            for name, kw in CONFIGS.items():
                if side == "jax":
                    traj, _m, info = jodo.run_odometry(jax.random.key(seed), feats, jnp.asarray(K),
                                                       window=WINDOW, return_info=True, **kw)
                    traj = todo.Trajectory(torch.from_numpy(np.array(traj.rvecs)),
                                           torch.from_numpy(np.array(traj.tvecs)))
                else:
                    draws = (dict(sampler=jax_sampler(jax.random.key(seed))) if side == "replay"
                             else dict())
                    gen = None if side == "replay" else torch.Generator().manual_seed(seed)
                    traj, _m, info = todo.run_odometry(gen, t_feats, torch.from_numpy(K),
                                                       window=WINDOW, return_info=True,
                                                       **draws, **kw)
                ate = float(ttraj.ate_rmse(ttraj.camera_centers(traj.rvecs, traj.tvecs), gt))
                print(f"seed {seed} {side:6s} {name:8s} loops {len(info['loop_frames']):2d} "
                      f"ATE {100 * ate / span:.3f}% of span {span:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
