"""Command-line entry point of the PyTorch port.

  python -m sift_parallel_optimization_tpu_torch.cli pyramid --size 512 --S 2 --device cuda
  python -m sift_parallel_optimization_tpu_torch.cli features --size 512 --device cuda
  python -m sift_parallel_optimization_tpu_torch.cli sfm --frames 6 --size 256 --device cuda
  python -m sift_parallel_optimization_tpu_torch.cli sfm --frames 40 --window 6 --loop-closure
  python -m sift_parallel_optimization_tpu_torch.cli stream --frames 200 --size 256 --window 6 --loop-closure

Defaults follow the JAX package's CLI (size 512, S=2, K=512; sfm: 6 frames
of 256^2; stream: 200 frames of 512^2). With ``--device cuda`` and no GPU
present the command fails; it never moves to the CPU on its own. ``sfm``
renders its frames with the port's host library (``utils/native``), or its
NumPy form where the library does not build; ``--image-dir`` reads frames
through the library. ``stream`` takes its frames from the library's ring
loader and fails where the library does not build.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return dev


def _load_image(args, device) -> torch.Tensor:
    from sift_parallel_optimization_tpu_torch.utils import native

    if args.image:
        img = native.read_pgm(args.image)
        side = min(img.shape)  # largest centred square crop
        y0 = (img.shape[0] - side) // 2
        x0 = (img.shape[1] - side) // 2
        img = np.ascontiguousarray(img[y0:y0 + side, x0:x0 + side])
    else:
        img = native.synth_frame(args.size, 0, seed=args.seed)
    return torch.from_numpy(img).to(device)


def _cmd_pyramid(args) -> int:
    dev = _device(args.device)
    img = _load_image(args, dev)
    if args.mode == "reference":
        from sift_parallel_optimization_tpu_torch.core.pyramid_ref import (
            reference_dog_pyramid,
        )

        out = reference_dog_pyramid(img, args.S)
    else:
        from sift_parallel_optimization_tpu_torch.config import (
            PyramidConfig,
            ScaleSpaceMode,
        )
        from sift_parallel_optimization_tpu_torch.core.pyramid_ref import (
            sift_dog_pyramid,
        )

        cfg = PyramidConfig(length=img.shape[0], S=args.S, mode=ScaleSpaceMode.SIFT)
        out = sift_dog_pyramid(img, cfg)
    for o, planes in enumerate(out):
        print(f"octave {o}: shape={tuple(planes.shape)} "
              f"mean={float(planes.mean()):+.5f} std={float(planes.std()):.5f}")
    if args.dump_dir:
        import os

        from sift_parallel_optimization_tpu_torch.utils import native

        os.makedirs(args.dump_dir, exist_ok=True)
        for o, planes in enumerate(out):
            p = planes[0].cpu().numpy()
            p = (p - p.min()) / max(p.max() - p.min(), 1e-9)
            native.write_pgm(f"{args.dump_dir}/octave{o}.pgm", p)
        print(f"dumped {len(out)} octaves to {args.dump_dir}")
    return 0


def _cmd_features(args) -> int:
    from sift_parallel_optimization_tpu_torch.models.frontend import (
        SiftFrontend,
        sift_config,
    )

    dev = _device(args.device)
    img = _load_image(args, dev)
    fe = SiftFrontend(sift_config(img.shape[0]), img.shape[0], img.shape[1],
                      max_keypoints=args.max_keypoints, device=dev)
    kp = fe(img).keypoints
    n = int(kp.count())
    print(f"{n} keypoints (capacity {kp.capacity})")
    if n:
        v = kp.valid.cpu().numpy()
        sig = kp.sigma.cpu().numpy()[v]
        print(f"  sigma range: {sig.min():.2f} .. {sig.max():.2f}")
        print(f"  octaves used: {sorted(set(kp.octave.cpu().numpy()[v].tolist()))}")
    return 0


def _save_traj(args, rvecs, tvecs, timestamps) -> None:
    """Export the estimated trajectory (``--save-traj``, TUM or KITTI)."""
    if not args.save_traj:
        return
    from sift_parallel_optimization_tpu_torch.utils.trajectory import save_kitti, save_tum

    if args.traj_format == "kitti":
        save_kitti(args.save_traj, rvecs, tvecs)
    else:
        save_tum(args.save_traj, timestamps, rvecs, tvecs)
    print(f"trajectory written to {args.save_traj} ({args.traj_format})")


def _gt_associations(args, frame_ts):
    """(frame indices, ground-truth centers) of ``--groundtruth``: KITTI is
    frame-indexed, TUM is associated by timestamp."""
    from sift_parallel_optimization_tpu_torch.utils.trajectory import (
        associate,
        load_kitti,
        load_tum,
    )

    if args.gt_format == "kitti":
        gt_centers, _ = load_kitti(args.groundtruth)
        ia = ib = np.arange(min(len(gt_centers), len(frame_ts)))
    else:
        gt_ts, gt_centers, _ = load_tum(args.groundtruth)
        ia, ib = associate(frame_ts, gt_ts, max_dt=args.max_dt)
    return ia, gt_centers[ib]


def _cmd_sfm(args) -> int:
    """Incremental SfM (``models/sfm.run_sfm``), or with ``--window`` the
    windowed odometry (``models/odometry.run_odometry``), on rendered frames
    or on a directory of frames, with the frontend's dual orientations and
    256 keypoints a frame; prints the map's counts, the reprojection RMS and
    the ATE after Sim(3) alignment, as the JAX package's ``cli sfm`` does."""
    if args.archive_policy != "fifo" and not (args.window and args.loop_closure):
        # The policy only exists inside the loop-closure archive: refuse it
        # rather than run another configuration than the one asked for.
        print("--archive-policy requires --window and --loop-closure "
              "(the archive ring only exists in loop-closed odometry)")
        return 2
    from sift_parallel_optimization_tpu_torch.models.ba import rms_error
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
    from sift_parallel_optimization_tpu_torch.models.odometry import run_odometry
    from sift_parallel_optimization_tpu_torch.models.sfm import run_sfm
    from sift_parallel_optimization_tpu_torch.utils import native
    from sift_parallel_optimization_tpu_torch.utils.trajectory import ate_rmse, camera_centers

    dev = _device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    intrinsics = lambda f, w, h: torch.tensor(
        [[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]], device=dev)
    if args.image_dir:
        # Real-data mode: frames sorted by name (TUM-style sequences name
        # frames by timestamp, so sorting IS temporal order), each
        # center-cropped to the smallest (height, width) of the set.
        import pathlib

        root = pathlib.Path(args.image_dir)
        paths = sorted(p for ext in ("*.pgm", "*.ppm", "*.png") for p in root.glob(ext))
        if len(paths) < 2:
            print(f"need >= 2 .pgm/.ppm/.png frames in {args.image_dir}")
            return 1
        paths = paths[: args.frames] if args.frames else paths
        raw = [native.imread(p) for p in paths]
        gh = min(im.shape[0] for im in raw)
        gw = min(im.shape[1] for im in raw)
        crop = lambda im, y0, x0: im[y0:y0 + gh, x0:x0 + gw]
        imgs = [crop(im, (im.shape[0] - gh) // 2, (im.shape[1] - gw) // 2) for im in raw]
        size = min(gh, gw)
        K = intrinsics(args.focal or float(size), gw, gh)
        frame_ts = []
        for i, p in enumerate(paths):
            try:
                frame_ts.append(float(p.stem))
            except ValueError:
                frame_ts.append(float(i))
        gt = None
    else:
        size = args.size
        focal = float(size)
        K = intrinsics(focal, size, size)
        gh = gw = size
        # Ground-truth trajectory through the native 3-D blob cloud: sideways
        # translation + slight yaw (real parallax).
        gt_r = np.stack([[0.0, 0.03 * i, 0.0] for i in range(args.frames)]).astype(np.float32)
        gt_t = np.stack([[-0.35 * i, 0.0, 0.04 * i] for i in range(args.frames)]).astype(
            np.float32)
        imgs = [native.render_frame(size, gt_r[i], gt_t[i], focal, seed=args.seed)
                for i in range(args.frames)]
        frame_ts = [float(i) for i in range(len(imgs))]
        gt = camera_centers(torch.from_numpy(gt_r).to(dev), torch.from_numpy(gt_t).to(dev))
    fe = SiftFrontend(sift_config(size), gh, gw, max_keypoints=256, dual_orientation=True,
                      device=dev)
    feats = [fe(torch.from_numpy(np.ascontiguousarray(im)).to(dev)) for im in imgs]
    if args.window:
        traj, m = run_odometry(gen, feats, K, window=args.window, loop_closure=args.loop_closure,
                               archive_policy=args.archive_policy,
                               marginalize=not args.no_marginalize)
        est_r, est_t = traj.rvecs, traj.tvecs
        print(f"window odometry (W={args.window}"
              f"{', loop closure' if args.loop_closure else ''}): {len(imgs)} frames, "
              f"{int(m.pt_valid.sum())} live landmarks")
    else:
        m = run_sfm(gen, feats, K, pair_selection=args.pair_selection)
        est_r, est_t = m.rvecs, m.tvecs
        print(f"cameras: {int(m.cam_valid.sum())}/{len(imgs)}  "
              f"landmarks: {int(m.pt_valid.sum())}  "
              f"observations: {int(m.obs.valid.sum())}")
    print(f"reprojection RMS: {float(rms_error(m.ba_state(), m.obs, K)):.3f} px")
    if args.image_dir:
        print(f"trajectory extent: {np.ptp(est_t.cpu().numpy(), axis=0).round(3).tolist()}")
    _save_traj(args, est_r, est_t, frame_ts)
    est = camera_centers(est_r, est_t)
    if args.groundtruth:
        ia, gt_c = _gt_associations(args, frame_ts)
        if len(ia) < 3:
            print(f"only {len(ia)} frame<->gt associations; no ATE")
            return 1
        ate = float(ate_rmse(est[torch.from_numpy(ia).to(dev)], torch.from_numpy(gt_c).to(dev)))
        span = float(np.linalg.norm(np.ptp(gt_c, axis=0)))
        print(f"ATE vs {args.groundtruth} over {len(ia)} poses: "
              f"{ate:.4f} ({100 * ate / max(span, 1e-9):.2f}% of span {span:.3f})")
        return 0
    if gt is not None:
        ate = float(ate_rmse(est, gt))
        span = float(np.linalg.norm(np.ptp(gt.cpu().numpy(), axis=0)))
        print(f"ATE (Sim3-aligned): {ate:.4f}  (trajectory span {span:.2f})")
    return 0


def upload_frame(frame: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host frame as a tensor on ``dev``: to the card through pinned
    memory without waiting for the copy (the caching host allocator does not
    hand the pinned block out again before the copy is done).

    The frame goes into pinned memory by a one-thread numpy copy, not by
    ``pin_memory()``: that copies with the intra-op thread pool, whose
    threads stall beside the loader's busy workers (on the H100 host: 2.9 ms
    against 1.6 for a 512^2 frame with its load, tools/stream_upload_probe.py).
    """
    if dev.type != "cuda":
        return torch.from_numpy(frame)
    pinned = torch.empty(frame.shape, dtype=torch.float32, pin_memory=True)
    np.copyto(pinned.numpy(), frame)
    return pinned.to(dev, non_blocking=True)


def serve_stream(frames: int, size: int, max_keypoints: int = 512, seed: int = 0,
                 window: int = 0, loop_closure: bool = False, device="cuda") -> dict:
    """The serving loop of ``cli stream``: the host library's ring loader ->
    ``SiftFrontend`` (dual orientations with a ``window``) -> with a
    ``window``, ``OdometryStream.push``; one warm-up frame first, then
    ``frames`` timed frames.

    Frames go to the card from pinned memory without blocking, and the
    keypoint counts stay on the device until one read at the end, so the
    host runs ahead of the card: loading frame i + 1 overlaps the device
    work of frame i. The time ends after the device has finished. Returns
    {"frames", "seconds", "keypoints" (total over the timed frames),
    "frontend" (the SiftFrontend), "stream" (the OdometryStream, not yet
    finished, or None)}.
    """
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
    from sift_parallel_optimization_tpu_torch.models.odometry import OdometryStream
    from sift_parallel_optimization_tpu_torch.utils import native

    dev = _device(str(device))
    fe = SiftFrontend(sift_config(size), max_keypoints=max_keypoints,
                      dual_orientation=bool(window), device=dev)
    stream = None
    if window:
        focal = float(size)
        K = torch.tensor([[focal, 0.0, size / 2], [0.0, focal, size / 2], [0.0, 0.0, 1.0]],
                         device=dev)
        stream = OdometryStream(torch.Generator(device=dev).manual_seed(seed), K, window=window,
                                loop_closure=loop_closure)
    with native.FrameLoader(size, n_buffers=4, n_threads=2, seed=seed) as ld:
        _, frame = ld.next_frame()
        int(fe(upload_frame(frame, dev)).keypoints.count())        # warm-up
        counts = []
        t0 = time.perf_counter()
        for _ in range(frames):
            _, frame = ld.next_frame()
            feats = fe(upload_frame(frame, dev))
            counts.append(feats.keypoints.count())
            if stream is not None:
                stream.push(feats)
        n_kp = int(torch.stack(counts).sum()) if counts else 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    return {"frames": frames, "seconds": dt, "keypoints": n_kp, "frontend": fe, "stream": stream}


def _cmd_stream(args) -> int:
    """Continuous serving: the host library's ring loader -> frontend, and
    with ``--window`` online odometry (``OdometryStream``); prints the
    end-to-end rate and, with a window, the stream's trajectory."""
    res = serve_stream(args.frames, args.size, args.max_keypoints, args.seed, args.window,
                       args.loop_closure, args.device)
    fps = res["frames"] / res["seconds"]
    print(f"{res['frames']} frames in {res['seconds']:.2f}s -> {fps:.1f} fps "
          f"({1e3 / fps:.2f} ms/frame end-to-end pipelined); "
          f"{res['keypoints'] / max(res['frames'], 1):.0f} keypoints/frame")
    if res["stream"] is not None:
        traj, _m, info = res["stream"].finish()
        c = traj.tvecs.cpu().numpy()
        print(f"online odometry (W={args.window}"
              f"{', loop closure' if args.loop_closure else ''}): {traj.rvecs.shape[0]} poses, "
              f"{len(info['loop_frames'])} loops, extent {np.ptp(c, axis=0).round(3).tolist()}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sift_parallel_optimization_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("pyramid", _cmd_pyramid), ("features", _cmd_features)):
        c = sub.add_parser(name)
        c.add_argument("--image", default=None, help="input PGM")
        c.add_argument("--size", type=int, default=512)
        c.add_argument("--seed", type=int, default=0)
        c.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")
        if name == "pyramid":
            c.add_argument("--S", type=int, default=2)
            c.add_argument("--mode", choices=("reference", "sift"), default="reference")
            c.add_argument("--dump-dir", default=None)
        else:
            c.add_argument("--max-keypoints", type=int, default=512)
        c.set_defaults(fn=fn)
    s = sub.add_parser("sfm", help="incremental SfM on rendered or real frames")
    s.add_argument("--frames", type=int, default=6)
    s.add_argument("--size", type=int, default=256)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--image-dir", default=None,
                   help="directory of .pgm/.ppm/.png frames (real-data mode)")
    s.add_argument("--focal", type=float, default=None,
                   help="focal length in px (default: image side)")
    s.add_argument("--groundtruth", default=None, help="trajectory file to gate ATE against")
    s.add_argument("--gt-format", choices=("tum", "kitti"), default="tum",
                   help="ground-truth format: TUM (timestamped quats) or KITTI "
                        "(frame-indexed 3x4 poses)")
    s.add_argument("--pair-selection", choices=("sequential", "covisibility"),
                   default="sequential",
                   help="registration order: 'sequential' (frame i vs i-1) or "
                        "'covisibility' (pairwise match-count table -> maximum-"
                        "covisibility spanning-tree order)")
    s.add_argument("--window", type=int, default=0,
                   help="sliding-window odometry with this window size (0 = full incremental "
                        "SfM; O(window) memory for long sequences)")
    s.add_argument("--loop-closure", action="store_true",
                   help="with --window: archive evicted landmarks and correct revisits by "
                        "pose-graph optimization")
    s.add_argument("--archive-policy", choices=("fifo", "coverage"), default="fifo",
                   help="with --loop-closure: ring-overwrite rule, 'fifo' (by age) or "
                        "'coverage' (overwrite the spatially most redundant block)")
    s.add_argument("--no-marginalize", action="store_true",
                   help="with --window: no fixed-landmark anchor factors for evicted blocks "
                        "(on by default; the ablation knob for drift studies)")
    s.add_argument("--save-traj", default=None, help="write the estimated trajectory here")
    s.add_argument("--traj-format", choices=("tum", "kitti"), default="tum")
    s.add_argument("--max-dt", type=float, default=0.02,
                   help="max timestamp gap for frame<->gt association (s)")
    s.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    s.set_defaults(fn=_cmd_sfm)
    st = sub.add_parser("stream", help="continuous serving loop: ring loader -> frontend "
                                       "[-> online odometry]")
    st.add_argument("--frames", type=int, default=200)
    st.add_argument("--size", type=int, default=512)
    st.add_argument("--max-keypoints", type=int, default=512)
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--window", type=int, default=0,
                    help="> 0: online sliding-window odometry on the stream "
                         "(models/odometry.OdometryStream); 0 = frontend-only serving")
    st.add_argument("--loop-closure", action="store_true",
                    help="with --window: archive-ring loop closure and an end-of-stream "
                         "pose-graph correction")
    st.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    st.set_defaults(fn=_cmd_stream)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
