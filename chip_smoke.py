#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sift_parallel_optimization_tpu_torch/
csrc``, checks each against its plain PyTorch version on the card (kernels
1 and 3 bit for bit, kernel 1 up to 4096^2, kernel 3 also on odd, wide,
constant, two-level and NaN DoGs), drives
the entry points (the REFERENCE DoG pyramid at 512^2, S=2; the SIFT
frontend at 512^2/K=512 and 1024^2/K=2048, S=3, on its default block-reduce
detection branch; the frontend with fused descriptor sampling at
512^2/K=512; the batched frontend on 8 frames at both sizes; a matched and
verified frame pair; the two-view bootstrap with a PnP registration of a
third view at 2048 keypoint slots per frame; incremental SfM with loop
closure on 50 keyframes, 128 landmarks a frame and 512 feature slots, on the
implicit-Schur CG solver; the SE(3) and Sim(3) pose-graph solvers on
synthetic graphs up to 1,000 nodes; and the tracking step: windowed odometry
over 120 rendered frames through the batched frontend, with archive loop
closure, its steady step as CUDA graphs; and online serving: OdometryStream
over the same features against run_odometry, and cli stream's loop from the
host library's ring loader through the frontend and OdometryStream at three
configurations; the distributed layer (parallel/) on a world-size-1 NCCL
mesh, every sharded entry point against its unsharded counterpart; and the
benchmark matrix through cli bench) and checks their
outputs against the port's per-frame, eager and CPU runs, against the truth
of the synthetic scenes and, for the bench records, against their floors in
bench/roofline.py (which also gives every kernel's bound). Every shape a
kernel launches at in the run must be one its check held it at. Each phase
prints one line (cli bench's records go before its line); then a JSON line of the
kernels, the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failure exits nonzero without that line. Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC_K1 = "sift_parallel_optimization_tpu_torch/csrc/reference_dog.cu"
SRC_K2 = "sift_parallel_optimization_tpu_torch/csrc/patch_gather.cu"
SRC_K3 = "sift_parallel_optimization_tpu_torch/csrc/score_tables.cu"
SRC_K4 = "sift_parallel_optimization_tpu_torch/csrc/gather_resample.cu"
# file:line of the TPU kernels each CUDA kernel replaces.
REPLACES_K1 = "sift_parallel_optimization_tpu/ops/scale_space_pallas.py:86"
REPLACES_K2 = "sift_parallel_optimization_tpu/ops/patch_gather.py:66"
REPLACES_K2B = "sift_parallel_optimization_tpu/ops/patch_gather.py:96"
REPLACES_K3 = "sift_parallel_optimization_tpu/ops/detect_fused.py:209"
REPLACES_K4 = "sift_parallel_optimization_tpu/ops/descriptor_fused.py:138"

# Kernel 1 vs its plain version: bitwise (the kernel's _rn arithmetic is the
# plain version's, op for op), at the headline size, the largest size of the
# JAX package's pyramid workload, a size where the stores and not the launch
# set the time, and sides that are no power of two (a ragged octave chain;
# 500: only octave 0 keeps 16-byte rows; 768: down to side 12); 256: the
# smallest side of cli bench's pyramid workload.
K1_SIZES = (256, 512, 1024, 4096, 1000, 500, 768)
K1_TIMED = (512, 1024, 4096)
# Headline vs the plain run on CPU tensors: exp of the window bank may
# differ by an ulp between the CPU and CUDA math libraries.
HEADLINE_ATOL = 1e-5
# Frontend, frame 0, card vs CPU: the two sum the blur products in another
# order, which can flip a candidate at a threshold; so >= 99% of CPU
# keypoints must be matched (same octave and scale, within 0.05 px) and
# >= 99% of matched descriptors must lie within L2 0.02.
MATCH_PX, MATCH_FRAC, DESC_L2, DESC_FRAC = 0.05, 0.99, 0.02, 0.99
# Kernel 4 vs its plain version (batched matmuls that may sum with FMAs).
K4_RTOL, K4_ATOL = 1e-5, 1e-6
# Keypoints of the block-reduce branch found by the exact one, frame 0.
RECALL_MIN = 0.95
# Frames of the per-frame frontend paths; the batched path takes BATCH frames.
FRAMES = 4
BATCH = 8
# Batched frontend vs the per-frame one on the card, frame by frame: the
# batched matrix products may sum in another order, which can move a
# coordinate by ~1e-5 px. Every slot must agree (valid, octave and scale
# equal; x, y, sigma within 1e-3) and >= 99% of the valid slots' descriptors
# must lie within L2 0.02.
BATCH_XY_ATOL, BATCH_SLOT_FRAC = 1e-3, 1.0
# The pair phase: frames 0 and 7 of the 512^2 stream (blob centres move by
# -0.9 px per frame in x), the gates of tests/test_matching.py's pair test.
PAIR_FRAMES, PAIR_SHIFT = (0, 7), (-6.3, 0.0)
# The two-view phase: 2048 keypoint slots per frame, two scenes of (width,
# height, focal length, point box low/high, three (rvec, tvec) poses). init_two_view
# keeps the winning MINIMAL sample's F (no refit over its inliers), so under
# 0.2 px noise the translation direction is only as good as the baseline is
# wide against the pixel: the gated scene is a 2048 x 1536 camera with a
# 1.5-unit baseline (direction within 3 deg); the scene of tests/test_sfm.py
# (400 x 300, f = 400, baseline 0.35) is run beside it, its readings printed
# and held to what that geometry supports with 30% outliers (rotation 2 deg,
# direction 30 deg; a CPU run of it reads 0.7 and 9.6 deg).
TV_SLOTS, TV_PTS_PER_FRAME, TV_OUTLIERS, TV_NOISE_PX = 2048, 512, 0.3, 0.2
TV_WIDE = (2048, 1536, 1200.0, (-5, -4, 3), (5, 4, 12), (
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
    ((0.02, 0.12, -0.01), (-1.5, 0.075, 0.15)),
    ((-0.01, 0.2, 0.02), (-2.7, -0.075, 0.375))))
TV_NARROW = (400, 300, 400.0, (-3, -3, 6), (3, 3, 12), tuple(
    ((0.0, 0.05 * i, 0.0), (-0.35 * i, 0.02 * i, 0.05 * i)) for i in range(3)))
# Landmarks pass init_two_view's own 2 px reprojection gate, so the worst
# kept error is below 2 by construction (it reads just under 2 whenever
# more candidates pass than the map has room for); what the pose and the
# points add is the MEDIAN error, which follows the winning minimal sample's
# pose error: 0.85 px in a CPU run of this scene, held to 1.5.
TV_MEDIAN_REPROJ_PX = 1.5
FRONTEND_CONFIGS = ((512, 3, 512), (1024, 3, 2048))
# The shapes each kernel is held to its plain version at: every (size, K)
# a main path gives it. 256^2: the stream's README run (per-frame gather at
# K=512, one frame a score-table launch), cli bench's tracking workload (its
# frames' per-frame gather at K=256) and the odometry phase (batched gather
# at K=256, 8 frames a launch).
K2_CONFIGS = ((256, 256), (256, 512), (512, 512), (1024, 2048))
K2B_CONFIGS = ((256, 256), (512, 512), (1024, 2048))
K3_FRONTEND = (256, 512, 1024)
K3_TIMED = ((256, 1), (512, 1), (512, 8), (1024, 1), (1024, 8))
# Device operations (kernels, copies, sets) one frame and one batch may
# take, as the mean of a few profiled calls, rounded: the counts of the tree
# before kernels 1 and 3 were redesigned (537 and 542 a frame, 557 and 565 a
# batch of 8), which a kernel change must not raise (no second launch, no
# per-call upload).
FRAME_OPS_MAX, BATCH_OPS_MAX = 542, 565
FUSED_CONFIG = (512, 3, 512)
# The kernels each path of the main path must launch.
PATH_KERNELS = {
    "headline": ("reference_dog_pyramid",),
    512: ("patch_gather", "score_tables"),
    1024: ("patch_gather", "score_tables"),
    "fused": ("score_tables", "gather_resample"),
    "batched 512": ("patch_gather_batched", "score_tables"),
    "batched 1024": ("patch_gather_batched", "score_tables"),
    "odometry": ("patch_gather_batched", "score_tables"),
    **{f"stream {name}": ("patch_gather", "score_tables") for name in "abc"},
    "bench": ("reference_dog_pyramid", "patch_gather", "score_tables"),
    "mesh": ("patch_gather_batched", "score_tables"),
    "mesh dryrun": ("reference_dog_pyramid",),
}
# Every kernel entry point as (module of sift_parallel_optimization_tpu_torch.
# ops, wrapper, name in the launch counts) with the arguments that make up
# the shape of a launch. Over the whole run each wrapper notes the shapes it
# launches at (LAUNCHED) and the checks note the shapes they held it to its
# plain version at (HELD); a launch at a shape that no check held fails.
SHAPED_WRAPPERS = (
    ("scale_space", "reference_dog_pyramid_cuda", "reference_dog_pyramid",
     lambda img, S, n_octaves=None: (tuple(img.shape), S, n_octaves)),
    ("patch_gather", "extract_atlas_patches_cuda", "patch_gather",
     lambda atlas, ys, xs, rows, cols: (tuple(atlas.shape), tuple(ys.shape), rows, cols)),
    ("patch_gather", "extract_atlas_patches_batched_cuda", "patch_gather_batched",
     lambda atlas, ys, xs, rows, cols: (tuple(atlas.shape), tuple(ys.shape), rows, cols)),
    ("score_tables", "score_tables_rows_cuda", "score_tables rows",
     lambda dog, thr, edge_ratio: (tuple(dog.shape),)),
    ("score_tables", "score_block_top2_cuda", "score_tables",
     lambda flat, shapes, thr, edge_ratio, refine_iters: (
         tuple(flat.shape), tuple(tuple(sh) for sh in shapes), refine_iters)),
    ("gather_resample", "gather_resample_cuda", "gather_resample",
     lambda atlas, grow, x0, params: (tuple(atlas.shape), tuple(grow.shape),
                                      tuple(params.shape))),
)
LAUNCHED: dict = {}
HELD: dict = {}
# The sfm phase: BASELINE.json configuration 4 ("incremental triangulation +
# bundle adjustment on ~50 keyframes"), as `cli sfm` runs it (256 keypoints
# a frame with dual orientations: 512 slots), on a seeded synthetic scene
# built as tests/test_sfm.py builds its features (0.2 px, 0.03 descriptor
# noise): SFM_LANDMARKS points in a box along a path that goes out
# SFM_FRAMES // 2 steps and comes back one step past its start, each frame
# seeing a random SFM_SLOTS of the landmarks in view. Gates: the solver
# "auto" picks, every camera registered, a loop accepted, reprojection RMS
# and the ATE gate of tests/test_sfm.py (2% of the trajectory's span).
SFM_FRAMES, SFM_PTS_PER_FRAME, SFM_SLOTS, SFM_LANDMARKS = 50, 128, 512, 1200
SFM_BOX = ((-5, -3, 6), (14, 3, 12))
SFM_RMS_PX, SFM_ATE_FRAC = 1.0, 0.02
# The sfm_cpu phase: the same run on the card and the CPU with the same
# draws, SFM_CPU_FRAMES frames with SFM_CPU_STEP a frame. At the sfm phase's
# 0.35 step (baseline / depth ~0.04) a 2e-5 px nudge of the keypoints moves
# an 8-frame map's raw translations by 7e-3 (a CPU run against itself), and
# card against CPU read 5.8e-3; at a 1.5 step the same nudges move them by
# 2-3e-4. Monocular SfM fixes camera 0 but not the scale about it, so
# rotations are held within 1e-3 rad as they are and camera centers within
# 1e-3 scene units after the Sim(3) alignment of the card's centers onto
# the CPU's (raw translations printed). Landmarks go through the same
# alignment and are compared as sets (a point at an inlier margin shifts its
# block's slots): >= 99% of the CPU run's within 2e-2 of the extent of a
# card landmark. Their depths are the loosest numbers of the map (0.2 px at
# depth 9 over a 1.5 baseline is ~3 cm) and a run's rounding moves them: a
# 1e-5 px nudge of the keypoints moved landmarks by up to 1.3% of the
# extent (median 0.5%) in a CPU run against itself, while the centers moved
# by 1.8e-4. The scene's landmarks lie ~0.8 apart, so 2e-2 of the extent
# (~0.1) still pairs a landmark with itself only. Valid masks differ in at
# most 1% of slots, reprojection RMS within 1%.
SFM_CPU_FRAMES, SFM_CPU_STEP = 8, (-1.5, 0.05, 0.1)
SFM_CPU_POSE_ATOL, SFM_CPU_PT_RTOL, SFM_CPU_FRAC = 1e-3, 2e-2, 0.99
# Dense and CG BA on one 20-camera map on the card: the same fixed point,
# rotations within 1e-4 rad and the Sim(3)-aligned structure within 1e-4 of
# its extent (the scale about camera 0 is free in monocular BA).
BA_FP_CAMS, BA_FP_PTS, BA_FP_RTOL = 20, 400, 1e-4
# The pgo phase: synthetic pose graphs on the card, built as
# tests/test_pose_graph_sim3.py builds its thousand-node one: a planar loop
# that passes its start every 200 nodes, an odometry chain integrated from
# the true relative steps (each step's length scaled by a growing factor:
# the monocular drift), chain edges measured from that estimate and metric
# loop edges carrying the true relative pose. PGO_NODES nodes with 3% step
# noise and a loop (i -> i + 100) every 20 nodes, in SE(3) and in Sim(3): one
# GN step of the chain + Woodbury solver and of CG (PGO_CG_ITERS trips) held
# against the dense step (f32 round-off of two LU-pivoted solves: rtol and
# atol 5e-4, as tests/test_torch_pose_graph.py at 300 nodes); then the
# 1,000-node scale ramp to 1.5x with loops (i -> i + 200) every 100 nodes
# through the chain solver, held to that
# test's gates (ATE below 0.15 of the drifted one, log_s's endpoint within
# 0.15 of the ramp, correlation above 0.95).
PGO_NODES, PGO_LOOP_EVERY, PGO_NOISE, PGO_CG_ITERS = 200, 20, 0.03, 400
PGO_RTOL, PGO_ATOL = 5e-4, 5e-4
RAMP_NODES, RAMP_ATE_FRAC, RAMP_LS_ATOL, RAMP_CORR = 1000, 0.15, 0.15, 0.95
# The odometry phase: tests/test_long_sequence.py's 120-frame three-cycle
# revisit at its configuration: ODO_SIZE^2 frames rendered with seed 3 (the
# NumPy renderer, on which the phase's readings were first taken; the host
# library's renderer agrees within 1e-5, and a run this long is chaotic
# enough for that to move its loops) along a triangle wave of
# period ODO_PERIOD, the frontend's 256 keypoints with dual orientations (512
# slots) from the batched frontend on the card, a window of 6 with 128
# landmarks a frame, draws from a generator seeded ODO_DRAW_SEED. Three runs,
# gated as that test gates them: windowed-only; loop closure with the default
# 64-block FIFO archive (>= 3 loops, none dropped, ATE under 5% of the span
# and at least 1.8x better than windowed-only, the window map's capacities
# O(window)); loop closure with an 8-block archive under the coverage policy
# (>= 6 loops, none dropped, ATE under 1.2% of the span). The steady step runs
# as CUDA graphs (the default on the card); on a prefix with loop closure it
# is held against the eager step with the same generator: both draw the same
# numbers and launch the same kernels, so they agree to f32 round-off (1e-4
# in rotations and in translations; a graph changes no arithmetic, so a
# larger gap is a capture fault). The prefix is 28 frames, not 20: the first
# revisit is accepted at frame 24 or so, and the prefix must hold one.
ODO_FRAMES, ODO_PERIOD, ODO_SIZE, ODO_SEED, ODO_KEYPOINTS = 120, 40, 256, 3, 256
ODO_WINDOW, ODO_PTS_PER_FRAME, ODO_DRAW_SEED, ODO_BATCH = 6, 128, 1, 8
ODO_ATE_FRAC, ODO_GAIN, ODO_MIN_LOOPS = 0.05, 1.8, 3
ODO_COV_BLOCKS, ODO_COV_MIN_LOOPS, ODO_COV_ATE_FRAC = 8, 6, 0.012
ODO_PREFIX, ODO_GRAPH_ATOL = 28, 1e-4
# The stream_equiv phase: OdometryStream over the odometry phase's features
# at its FIFO configuration and draw seed, with the loop buffer's capacity
# run_odometry picked there, held to that run: the same loops, and poses
# within 1e-5 (the JAX package's stream test's atol) before and after the
# end-of-run correction. run_odometry drives a stream that knows its length
# (n = 120, (n - 1) % 2 == 1), so it BAs its last frame inside frame 119's
# step, the stream in finish(); the loop proposal does not read the window
# map, so the two orders agree.
STREAM_EQUIV_ATOL = 1e-5
# The stream phase: cli stream's serving loop (cli.serve_stream: the host
# library's ring loader, 2 threads, 4 buffers -> SiftFrontend -> optional
# OdometryStream.push), STREAM_FRAMES timed frames after one warm-up frame,
# K=512, seed 0, in three runs of (name, size, window, loop closure): (a) the
# CLI's defaults, frontend only; (b) the README's example; (c) 512^2 with
# OdometryStream's default window. Every frame launches kernels 3 and 2a
# once. Pushes that replay a captured step run under
# torch.cuda.set_sync_debug_mode("error"): a host sync there fails the
# phase; the other pushes and the frontend run under "warn" and their syncs
# are counted and printed.
STREAM_FRAMES = 200
# Then the loop goes on for one more frame and STREAM_PROFILED frames under
# torch.profiler (utils/profiling.profile_device): the device time of a
# steady served frame, and its busy share of the timed frame.
STREAM_PROFILED = 4
STREAM_RUNS = (("a", 512, 0, False), ("b", 256, 6, True), ("c", 512, 8, True))
# The bench phase: cli bench on the card (bench/suite.py's records), in two
# calls: the pyramid workload at its own sizes (256, 512 and 1024^2, kernel 1
# and the plain version), then frontend, matching and tracking at 256^2; its
# launches counted as a path of their own (PATH_KERNELS["bench"]).
# Every record must hold a finite value above 0, name this card (nvidia-smi's
# name and power limit) and, where it has a share of the roofline, read at
# most 100% of it: more means the floor is wrong.
# The mesh phase: the distributed layer (parallel/) on a (1, 1) DeviceMesh
# of a world-size-1 NCCL group on this card (NCCL refuses two ranks on one
# device, so a mesh of n ranks needs n cards: torch.cuda.device_count();
# the exchanges between ranks are held at 2 and 4 gloo ranks by the CPU
# tests). Every sharded entry point against its unsharded counterpart on
# the card: the three REFERENCE decompositions at 512^2 bitwise against
# kernel 1's pyramid; the SIFT sharded pyramid at 512^2 and 1024^2 within
# 1e-5 (band products over the halo against dense Toeplitz products); the
# mesh frontend on the batched phase's 512^2 frames slot for slot as that
# phase holds them (its launches counted as a path: kernels 3 and 2b once);
# the ring table on the sfm phase's keyframes exactly; distributed BA, dense
# and CG, 20 steps on the sfm_cpu phase's arc within 1e-4 of each field's
# largest magnitude; distributed PGO on the pgo phase's 200-node SE(3)
# graph (MESH_PGO_ITERS dense steps) and close_loops(mesh=) on the sfm
# phase's map (its written loops, at their current poses) within 1e-4;
# dryrun_multichip(1) finite, its launches counted as a path of its own
# (PATH_KERNELS["mesh dryrun"]: kernel 1 once for each of its two 64^2
# frames, held at that shape first). Then each pair's per-call ms between CUDA
# events: the mesh layer's cost at world size 1.
MESH_SIFT_ATOL, MESH_STATE_RTOL, MESH_POSE_ATOL, MESH_PGO_ITERS = 1e-5, 1e-4, 1e-4, 5
BENCH_RUNS = (("pyramid", None), ("frontend,matching,tracking", 256))
BENCH_RECORDS = 12
THR = 0.04 / 3          # detect.CONTRAST_THRESHOLD / S
EDGE_RATIO = 10.0


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


T_START = time.perf_counter()


def phase(name: str, msg: str) -> None:
    """One line per phase, ending in the seconds since the script began."""
    print(f"[{name}] {msg} [t+{time.perf_counter() - T_START:.0f} s]", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def keyset(kp) -> set:
    v = kp.valid.cpu()
    return set(zip(*(f.cpu()[v].mul(1000).round().tolist() for f in (kp.x, kp.y, kp.sigma))))


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (torch.equal on the f32 tensors' int32 views, so
    that nothing hides behind a NaN)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def max_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def kernel1_checks(torch, ss, dev):
    """Kernel vs plain on the card, bitwise, at every side of K1_SIZES (S=2,
    all octaves). Returns (max abs error, {side: image} of the timed sides)."""
    import numpy as np

    errs, imgs = [], {}
    for n in K1_SIZES:
        img = torch.from_numpy(
            np.random.default_rng(n).random((n, n), dtype=np.float32)
        ).to(dev)
        got = ss.reference_dog_pyramid_cuda(img, 2)
        want = ss.reference_dog_pyramid_plain(img, 2)
        torch.cuda.synchronize()
        check(len(got) == len(want), f"kernel 1: octave count at {n}")
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"kernel 1: shape {tuple(g.shape)} at {n}")
            check(torch.equal(g, w),
                  f"kernel 1 not bitwise equal to plain at {n}: {max_err(got, want)}")
        held("reference_dog_pyramid", img, 2)
        errs.append(max_err(got, want))
        if n in K1_TIMED:
            imgs[n] = img
        del got, want
    return max(errs), imgs


def frontend_atlas(torch, dev, size, S):
    """The descriptor atlas the frontend builds for a size^2 frame."""
    from sift_parallel_optimization_tpu_torch.models import descriptor, frontend
    from sift_parallel_optimization_tpu_torch.utils import native

    fe = frontend.SiftFrontend(frontend.sift_config(size, S=S), device=dev)
    img = torch.from_numpy(native.synth_frame(size, 0, seed=0)).to(dev)
    atlas, _meta = descriptor.build_atlas(fe.pyramid(img))
    return atlas


def gather_origins(torch, rng, k, r, c, rows, cols, dev):
    ys = rng.integers(0, (r - rows) // 8 + 1, size=k).astype("int32") * 8
    xs = rng.integers(0, (c - cols) // 128 + 1, size=k).astype("int32") * 128
    ys[0], xs[0] = r - rows, c - cols          # last legal row and column
    ys[1], xs[1] = r - rows, 0
    return (torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev))


def frontend_dogs(torch, dev, size, S, n_frames):
    """The DoG octaves the frontend detects on for the first ``n_frames``
    frames of a size^2 stream: one (n_frames, S+2, H_o, W_o) tensor per octave."""
    from sift_parallel_optimization_tpu_torch.models import frontend
    from sift_parallel_optimization_tpu_torch.utils import native

    fe = frontend.SiftFrontend(frontend.sift_config(size, S=S), device=dev)
    batch = torch.stack([torch.from_numpy(native.synth_frame(size, i, seed=0))
                         for i in range(n_frames)]).to(dev)
    return [g[:, 1:] - g[:, :-1] for g in fe.pyramid(batch)]


def flat_frames(torch, dogs):
    """(B, S+2, H_o, W_o) octaves -> the (B, L) flat DoG, each frame's octaves
    back to back, and the octave shapes: what detection hands to kernel 3."""
    b = dogs[0].shape[0]
    return (torch.cat([d.reshape(b, -1) for d in dogs], dim=1).contiguous(),
            [tuple(d.shape[1:]) for d in dogs])


# Kernel 3 cases its tiled design can get wrong, as name -> (octave shapes,
# kind of DoG, frames): 64-voxel blocks that straddle score planes and rows
# that are no multiple of 64 or of 4 wide, an octave whose offset in the flat
# DoG is odd (no 16-byte rows), octaves under 4096 voxels beside them, rows
# too wide for three of them in the slab (windows of columns), more score
# planes than a tile is long, large constant regions (the non-strict extremum
# test holds everywhere there), a two-level DoG (EVERY voxel is an extremum of
# a cube that is not constant: the list takes whole tiles), NaNs (a voxel
# with a NaN in its cube scores 0 in the plain version), and a frame count
# that is no power of two.
K3_ODD = ((5, 131, 77), (5, 66, 39), (5, 33, 20))
K3_EXTRA = {
    "odd octaves": (K3_ODD, "noise", 1),
    "odd octaves, 3 frames": (K3_ODD, "noise", 3),
    "odd octaves, constant regions": (K3_ODD, "flat", 1),
    "odd octaves, two levels": (K3_ODD, "levels", 1),
    "odd octaves, NaNs": (K3_ODD, "nan", 1),
    "two levels 250x370": (((5, 250, 370),), "levels", 1),
    "constant regions 250x370": (((5, 250, 370),), "flat", 3),
    "wide rows 12x2600": (((5, 12, 2600),), "noise", 1),
    "many planes 24x28": (((12, 24, 28),), "noise", 1),
}


def k3_extra_frame(shapes, kind, seed):
    """One frame's DoG octaves of a K3_EXTRA case, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = 0.05 * rng.normal(size=s)
        if kind == "flat":
            a[:, : s[1] // 2, :] = 0.0
            a[:, :, : s[2] // 3] = 0.25
        elif kind == "levels":
            a = np.where(rng.random(size=s) < 0.5, -0.03, 0.04)
        elif kind == "nan":
            a[rng.random(size=s) < 0.01] = np.nan
        out.append(a.astype(np.float32))
    return out


def kernel3_checks(torch, st, dev):
    """Both entry points vs their plain versions, bitwise: the rows tables on
    random DoG stacks and on the frontend's octaves; the block top-2 tables
    on the same, one frame a launch (the per-frame frontend's form), and on
    the BATCH frames of each K3_FRONTEND size in one launch (the batched
    frontend's form), for refine 0 and 1. Returns (cases, max abs error,
    random stacks, {size: (flat (BATCH, L), shapes)})."""
    import numpy as np

    stacks = {f"random {s[1]}x{s[2]}": [torch.from_numpy(
        (0.05 * np.random.default_rng(s[1]).normal(size=s)).astype(np.float32)).to(dev)[None]]
        for s in ((5, 512, 512), (5, 1024, 1024), (5, 250, 370))}
    for name, (shapes, kind, b) in K3_EXTRA.items():
        stacks[name] = [torch.from_numpy(np.stack(d)).to(dev)
                        for d in zip(*(k3_extra_frame(shapes, kind, i) for i in range(b)))]
    flats = {}
    for size in K3_FRONTEND:
        dogs = frontend_dogs(torch, dev, size, 3, BATCH)
        flats[size] = flat_frames(torch, dogs)
        stacks[f"frontend {size}^2 octaves"] = [d[:1] for d in dogs]
    cases, err = 0, 0.0

    def hold(flat, shapes, name):
        nonlocal cases, err
        for refine in (0, 1):
            got = st.score_block_top2_cuda(flat, shapes, THR, EDGE_RATIO, refine)
            want = st.score_block_top2_plain(flat, shapes, THR, EDGE_RATIO, refine)
            torch.cuda.synchronize()
            check(all(g.shape[0] == flat.shape[0] and same_bits(torch, g, w)
                      for g, w in zip(got, want)),
                  f"kernel 3 block top-2 not bitwise equal to plain on {name}, refine {refine}")
            held("score_tables", flat, shapes, THR, EDGE_RATIO, refine)
            err = max(err, max_err(got, want))
            cases += 1

    for name, dogs in stacks.items():
        for dog in dogs:
            got = st.score_tables_rows_cuda(dog[0].contiguous(), THR, EDGE_RATIO)
            want = st.score_tables_rows_plain(dog[0], THR, EDGE_RATIO)
            torch.cuda.synchronize()
            check(all(same_bits(torch, g, w) for g, w in zip(got, want)),
                  f"kernel 3 rows not bitwise equal to plain on {name} {tuple(dog.shape[1:])}")
            held("score_tables rows", dog[0], THR, EDGE_RATIO)
            err = max(err, max_err(got, want))
            cases += 1
        hold(*flat_frames(torch, dogs), f"{name}, {dogs[0].shape[0]} frame(s) in one launch")
    for size, (flat, shapes) in flats.items():
        check(flat.shape[0] == BATCH, f"kernel 3: {size}^2 batch shape")
        hold(flat, shapes, f"the {BATCH} frames of the {size}^2 stream in one launch")
    return cases, err, stacks, flats


def kernel4_inputs(torch, rng, k, atlas, dev):
    """In-range keypoints as the fused branch forms them: origins aligned to
    8 rows and 128 columns, centres and radii inside the 128 x 256 patch."""
    r, c = atlas.shape
    grow = rng.integers(0, (r - 128) // 8 + 1, size=k).astype("int32") * 8
    x0 = rng.integers(0, (c - 256) // 128 + 1, size=k).astype("int32") * 128
    grow[0], x0[0] = r - 128, c - 256
    params = np.stack([rng.uniform(56, 72, k), rng.uniform(136, 156, k),
                       rng.uniform(2, 17, k), rng.uniform(4, 51, k)], 1).astype("float32")
    return (atlas, torch.from_numpy(grow).to(dev), torch.from_numpy(x0).to(dev),
            torch.from_numpy(params).to(dev))


def device_profile(torch, fn, *args, iters=10):
    """(device activities, device ms) per call from one profiler run."""
    from sift_parallel_optimization_tpu_torch.utils.profiling import profile_device

    return profile_device(fn, *args, warmup=1, iters=iters)[:2]


def flushed_kernel_ms(torch, fn, *args, iters=20):
    """Median device ms of ``fn(*args)`` with the L2 flushed before each
    call (a read of twice the L2's size between the calls, outside the
    CUDA events around the call, so the L2 holds clean lines of another
    buffer): what the call costs when its inputs come from HBM. A spin of
    the device after the flush keeps the host's enqueue of the call out
    of the events."""
    dev = args[0].device
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    scratch = torch.ones(max(2 * l2, 1 << 26) // 4, dtype=torch.float32, device=dev)
    fn(*args)
    pairs = []
    for _ in range(iters):
        scratch.amax()
        torch.cuda._sleep(2_000_000)       # ~1 ms of device time: the host enqueues ahead
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(dev)
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def frame_ms(torch, fe, frames, passes=2):
    """Median and max host ms of a synchronized frame over ``passes`` passes."""
    samples = []
    for _ in range(passes):
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fe(f)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples)), max(samples), len(samples)


def record_shapes():
    """Wrap every kernel entry point so that it notes each launch's shape in
    LAUNCHED. The dispatchers call the wrappers through their modules'
    globals, so every path of the run goes through the note."""
    import functools
    import importlib

    for module, attr, name, key in SHAPED_WRAPPERS:
        mod = importlib.import_module(f"sift_parallel_optimization_tpu_torch.ops.{module}")
        fn = getattr(mod, attr)

        @functools.wraps(fn)
        def noted(*args, _fn=fn, _name=name, _key=key, **kw):
            LAUNCHED.setdefault(_name, set()).add(_key(*args, **kw))
            return _fn(*args, **kw)

        setattr(mod, attr, noted)


def held(name, *args) -> None:
    """Note that kernel ``name`` was held to its plain version at the shape
    of ``args`` (the wrapper's arguments)."""
    key = next(k for _m, _a, n, k in SHAPED_WRAPPERS if n == name)
    HELD.setdefault(name, set()).add(key(*args))


def counted(torch, counters, fn):
    """Run one path with every launch counter set to 0 just before it;
    returns (its output, each kernel's launches during it)."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def drive_main_path(torch, dev, frames, counters):
    """The port's entry points, as a user calls them, each path counted on
    its own: the headline pyramid, the frontend (default branches) at both
    sizes, the frontend with fused descriptor sampling, and the batched
    frontend on BATCH frames at both sizes. Returns (pyramid, features,
    per-path launch counts)."""
    from sift_parallel_optimization_tpu_torch.core.pyramid_ref import reference_dog_pyramid
    from sift_parallel_optimization_tpu_torch.models import descriptor
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
    from sift_parallel_optimization_tpu_torch.parallel.frontend import batched_extract_features

    launches = {}
    pyr, launches["headline"] = counted(
        torch, counters, lambda: reference_dog_pyramid(frames["headline"], 2))
    feats = {}
    for size, S, k in FRONTEND_CONFIGS:
        fe = SiftFrontend(sift_config(size, S=S), max_keypoints=k, device=dev)
        out, launches[size] = counted(
            torch, counters, lambda: [fe(f) for f in frames[size][:FRAMES]])
        feats[size] = (fe, out)
        batch = torch.stack(frames[size])
        out, launches[f"batched {size}"] = counted(
            torch, counters, lambda: batched_extract_features(batch, sift_config(size, S=S), k))
        feats[f"batched {size}"] = (fe, out)
    size, S, k = FUSED_CONFIG
    fe = SiftFrontend(sift_config(size, S=S), max_keypoints=k, device=dev)
    descriptor.USE_FUSED_SAMPLING = True
    try:
        out, launches["fused"] = counted(
            torch, counters, lambda: [fe(f) for f in frames[size][:FRAMES]])
        feats["fused"] = (fe, out)
    finally:
        descriptor.USE_FUSED_SAMPLING = False
    return pyr, feats, launches


def check_features(torch, feats, size, k):
    for i, f in enumerate(feats):
        kp, desc = f.keypoints, f.descriptors
        check(desc.shape == (k, 128) and kp.capacity == k, f"frontend {size}: shapes")
        check(bool(torch.isfinite(desc).all()), f"frontend {size} frame {i}: nonfinite")
        n = int(kp.count())
        check(n > 0, f"frontend {size} frame {i}: no keypoints")
        norms = torch.linalg.vector_norm(desc, dim=1)
        check(bool(((norms[kp.valid] - 1).abs() < 1e-3).all()),
              f"frontend {size} frame {i}: descriptors not unit norm")
        check(bool((desc[~kp.valid] == 0).all()),
              f"frontend {size} frame {i}: invalid slots not zero")


def compare_with_cpu(torch, gpu, cpu, size):
    """Fraction of CPU keypoints matched on the card and fraction of matched
    descriptors within DESC_L2."""
    g, c = gpu.keypoints, cpu.keypoints
    gv, cv = g.valid.cpu(), c.valid
    gx, gy = g.x.cpu()[gv], g.y.cpu()[gv]
    go, gs = g.octave.cpu()[gv], g.scale.cpu()[gv]
    gd = gpu.descriptors.cpu()[gv]
    cx, cy, co, cs = c.x[cv], c.y[cv], c.octave[cv], c.scale[cv]
    cd = cpu.descriptors[cv]
    check(len(cx) > 0 and len(gx) > 0, f"frontend {size}: no keypoints to compare")
    dist = torch.maximum((cx[:, None] - gx[None]).abs(), (cy[:, None] - gy[None]).abs())
    same = (co[:, None] == go[None]) & (cs[:, None] == gs[None])
    best, j = torch.where(same, dist, torch.full_like(dist, float("inf"))).min(dim=1)
    matched = best <= MATCH_PX
    frac = float(matched.float().mean())
    l2 = torch.linalg.vector_norm(cd[matched] - gd[j[matched]], dim=1)
    dfrac = float((l2 <= DESC_L2).float().mean()) if len(l2) else 0.0
    return frac, dfrac, int(cv.sum()), int(gv.sum())


def frame_of(feats, i):
    """Frame i of Features that carry a leading batch axis."""
    return type(feats)(type(feats.keypoints)(*[f[i] for f in feats.keypoints]),
                       feats.descriptors[i])


def batched_gather_origins(torch, rng, b, k, r, c, rows, cols, dev):
    """(B, K) aligned origins with the edge cases of the batched gather: the
    last legal row and column of the LAST frame, and in a middle frame a
    negative origin (counts from that frame's own end) and an over-range one
    (clamps into that frame, not into the next one's rows)."""
    ys = rng.integers(0, (r - rows) // 8 + 1, size=(b, k)).astype("int32") * 8
    xs = rng.integers(0, (c - cols) // 128 + 1, size=(b, k)).astype("int32") * 128
    ys[-1, -1], xs[-1, -1] = r - rows, c - cols
    ys[-1, -2], xs[-1, -2] = r - rows, 0
    ys[b // 2, 0], xs[b // 2, 0] = -8, -128
    ys[b // 2, 1], xs[b // 2, 1] = r + 64, c + 128
    return torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)


def gather_index_call(torch, atlas, ys, xs, rows, cols):
    """The one PyTorch call nearest to the gather kernels: advanced indexing
    with index tensors built beforehand (the plain versions build them and
    then make this call). Returns a function of no arguments."""
    r, c = atlas.shape[-2:]
    y0, x0 = ys.long(), xs.long()
    y0 = torch.where(y0 < 0, y0 + r, y0).clamp(0, r - rows)
    x0 = torch.where(x0 < 0, x0 + c, x0).clamp(0, c - cols)
    ri = (y0[..., None] + torch.arange(rows, device=atlas.device))[..., :, None]
    ci = (x0[..., None] + torch.arange(cols, device=atlas.device))[..., None, :]
    if atlas.dim() == 2:
        return lambda: atlas[ri, ci]
    bi = torch.arange(atlas.shape[0], device=atlas.device)[:, None, None, None]
    return lambda: atlas[bi, ri, ci]


def compare_frames(torch, got, ref):
    """One frame of the batched frontend against the per-frame frontend on
    the card: (fraction of slots that agree, fraction of the agreeing valid
    slots whose descriptors lie within DESC_L2)."""
    g, r = got.keypoints, ref.keypoints
    same = (g.valid == r.valid) & (g.octave == r.octave) & (g.scale == r.scale)
    for f in ("x", "y", "sigma"):
        same &= (getattr(g, f) - getattr(r, f)).abs() <= BATCH_XY_ATOL
    both = same & r.valid
    l2 = torch.linalg.vector_norm(got.descriptors[both] - ref.descriptors[both], dim=1)
    dfrac = float((l2 <= DESC_L2).float().mean()) if l2.numel() else 1.0
    return float(same.float().mean()), dfrac


def call_times(torch, fn, iters=20, warmup=3, profiled=5):
    """(median ms per call between CUDA events, device ops, device ms) of
    fn(); ``profiled`` calls in the profiler run (a run of a call that
    launches thousands of kernels takes the profiler seconds to read)."""
    from sift_parallel_optimization_tpu_torch.utils.profiling import cuda_time_ms

    return (cuda_time_ms(fn, warmup=warmup, iters=iters),) + device_profile(
        torch, fn, iters=profiled)


def fmt_times(times: dict) -> str:
    return "; ".join(f"{name} {ms:.3f} ms/call (device {dms:.3f} ms in {n:.0f} ops)"
                     for name, (ms, n, dms) in times.items())


def rodrigues_np(w):
    theta = float(np.linalg.norm(w))
    if theta < 1e-12:
        return np.eye(3)
    k = np.asarray(w, np.float64) / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def rotation_angle_deg(Ra, Rb) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))))


def twoview_scene(scene, seed=0):
    """Features of three cameras looking at one seeded 3-D scene, as
    tests/test_sfm.py's ``_make_features`` builds them: TV_SLOTS points in
    front of all cameras, one unit random 128-d descriptor per point shared
    by the views (plus 0.03 noise), TV_NOISE_PX pixel noise; in view 1 the
    first TV_OUTLIERS of the slots are outliers (the point's descriptor at a
    random pixel). Returns (numpy feature dicts, poses, intrinsics, number of
    outlier slots)."""
    TV_W, TV_H, TV_F, lo, hi, poses = scene
    rng = np.random.default_rng(seed)
    n = TV_SLOTS
    k_np = np.array([[TV_F, 0, TV_W / 2], [0, TV_F, TV_H / 2], [0, 0, 1]], np.float32)
    pts = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    descs = rng.normal(size=(n, 128)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    poses = [(np.array(rv), np.array(tv)) for rv, tv in poses]
    n_out = int(TV_OUTLIERS * n)
    feats = []
    for i, (rv, tv) in enumerate(poses):
        pc = pts @ rodrigues_np(rv).T.astype(np.float32) + tv.astype(np.float32)
        uv = ((pc / pc[:, 2:]) @ k_np.T)[:, :2]
        uv = uv + rng.normal(size=uv.shape).astype(np.float32) * TV_NOISE_PX
        vis = ((pc[:, 2] > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < TV_W - 5)
               & (uv[:, 1] > 5) & (uv[:, 1] < TV_H - 5))
        if i == 1:
            uv[:n_out] = rng.uniform([5, 5], [TV_W - 5, TV_H - 5], size=(n_out, 2))
        d = descs + rng.normal(size=descs.shape).astype(np.float32) * 0.03
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        feats.append({
            "keypoints": {
                "x": uv[:, 0].astype(np.float32), "y": uv[:, 1].astype(np.float32),
                "sigma": np.full(n, 2.0, np.float32), "score": np.ones(n, np.float32),
                "orientation": np.zeros(n, np.float32), "octave": np.zeros(n, np.int32),
                "scale": np.ones(n, np.int32), "valid": vis,
            },
            "descriptors": d.astype(np.float32),
        })
    return feats, poses, k_np, n_out


def pair_phase(torch, dev, feats):
    """Frames PAIR_FRAMES of the batched 512^2 result -> match -> points ->
    RANSAC homography on the card, against the known shift and against the
    same calls on CPU copies with the same injected draws."""
    from sift_parallel_optimization_tpu_torch.models import matching as tm

    def chain(f0, f1, idx=None, gen=None):
        m = tm.match_descriptors(f0.descriptors, f1.descriptors, f0.keypoints.valid,
                                 f1.keypoints.valid)
        p1, p2, mask = tm.matched_points(f0.keypoints, f1.keypoints, m)
        if idx is None:
            idx = tm._sample_indices(gen, mask, 256, 4)
        return p1, p2, mask, idx, tm.ransac_homography(None, p1, p2, mask, 256, 1.5,
                                                       sample_idx=idx)

    f0, f1 = (frame_of(feats, i) for i in PAIR_FRAMES)
    seeded = lambda: torch.Generator(device=dev).manual_seed(0)
    p1, p2, mask, idx, res = chain(f0, f1, gen=seeded())
    torch.cuda.synchronize()
    n_pairs, n_inl = int(mask.sum()), int(res.n_inliers)
    check(n_pairs >= 10, f"pair: only {n_pairs} pair-valid matches")
    check(n_inl >= n_pairs * 2 // 3, f"pair: {n_inl} inliers of {n_pairs} matches")
    check(bool(mask[idx].all()), "pair: a draw fell on an invalid slot")
    h = (res.model / res.model[2, 2]).cpu().numpy()
    check(abs(h[0, 2] - PAIR_SHIFT[0]) < 1.0 and abs(h[1, 2] - PAIR_SHIFT[1]) < 1.0,
          f"pair: translation {h[0, 2]:.3f}, {h[1, 2]:.3f} is not {PAIR_SHIFT}")
    check(abs(h[0, 0] - 1) < 0.05 and abs(h[1, 1] - 1) < 0.05, f"pair: diagonal of {h}")
    # The generator path gives the same draws from the same seed.
    again = tm.ransac_homography(seeded(), p1, p2, mask, 256, 1.5)
    check(torch.equal(again.inliers, res.inliers), "pair: seeded draws are not reproducible")
    cpu_f = [type(f)(type(f.keypoints)(*[t.cpu() for t in f.keypoints]), f.descriptors.cpu())
             for f in (f0, f1)]
    cpu = chain(*cpu_f, idx=idx.cpu())[4]
    differ = float((cpu.inliers != res.inliers.cpu()).float().mean())
    check(differ <= 0.01, f"pair: inlier masks of card and CPU differ in {differ:.4f} of slots")
    times = {
        "match_descriptors": call_times(torch, lambda: tm.match_descriptors(
            f0.descriptors, f1.descriptors, f0.keypoints.valid, f1.keypoints.valid)),
        "ransac_homography": call_times(torch, lambda: tm.ransac_homography(
            seeded(), p1, p2, mask, 256, 1.5)),
    }
    phase("pair", f"frames {PAIR_FRAMES} of the batched 512^2 result: {n_pairs} pair-valid "
          f"matches, {n_inl} inliers (256 hypotheses, threshold 1.5), H translation "
          f"({h[0, 2]:.3f}, {h[1, 2]:.3f}) vs {PAIR_SHIFT}, diagonal ({h[0, 0]:.4f}, "
          f"{h[1, 1]:.4f}); CPU with the same draws: masks differ in {differ:.4f} of slots; "
          + fmt_times(times))


def twoview_phase(torch, dev):
    """init_two_view on a synthetic two-camera scene at TV_SLOTS slots per
    frame, then ransac_pnp of a third view, against the truth and against
    the port's CPU run under the same injected draws (the TV_WIDE scene); and
    init_two_view on the TV_NARROW scene against the truth."""
    from sift_parallel_optimization_tpu_torch.models import geometry as tgeo
    from sift_parallel_optimization_tpu_torch.models import matching as tm
    from sift_parallel_optimization_tpu_torch.models import sfm
    from sift_parallel_optimization_tpu_torch.models.frontend import features_from_numpy

    B = TV_PTS_PER_FRAME
    seeded = lambda: torch.Generator(device=dev).manual_seed(0)

    def run(arrays, k_np, device, idx=None, pnp_idx=None, third=True):
        f = [features_from_numpy(a, device=device) for a in arrays]
        K = torch.from_numpy(k_np).to(device)
        m0 = sfm.empty_map(3, B, device=device)
        match = tm.match_descriptors(f[0].descriptors, f[1].descriptors,
                                     f[0].keypoints.valid, f[1].keypoints.valid)
        p0, p1, pair_ok = tm.matched_points(f[0].keypoints, f[1].keypoints, match)
        if idx is None:
            idx = tm._sample_indices(seeded(), pair_ok, sfm.BOOTSTRAP_HYPOTHESES, 8)
        m, used_a, _used_b = sfm.init_two_view(None, f[0], f[1], K, m0, B,
                                               return_used_pair=True, sample_idx=idx)
        out = dict(f=f, K=K, m0=m0, m=m, used_a=used_a, idx=idx, p0=p0, p1=p1,
                   pair_ok=pair_ok)
        if not third:
            return out
        m2 = tm.match_descriptors(m.pt_desc, f[2].descriptors, m.pt_valid, f[2].keypoints.valid)
        pts2d = torch.stack([f[2].keypoints.x[m2.idx2], f[2].keypoints.y[m2.idx2]], -1)
        pnp_mask = m2.valid & f[2].keypoints.valid[m2.idx2]
        if pnp_idx is None:
            pnp_idx = tm._sample_indices(seeded(), pnp_mask, 128, 6)
        cam, inl, n_inl = sfm.ransac_pnp(None, m.points, pts2d, pnp_mask, K, 128,
                                         sample_idx=pnp_idx)
        out.update(pnp_idx=pnp_idx, cam=cam, n_inl=n_inl, pts2d=pts2d, pnp_mask=pnp_mask)
        return out

    def against_truth(name, res, arrays, poses, n_out):
        """Pose (unit baseline: the scale is free) and landmarks of one
        bootstrap against the scene: (rotation deg, direction deg, landmarks
        kept, true inliers, median and worst reprojection px)."""
        m = res["m"]
        check(m.cam_valid.tolist() == [True, True, False], f"twoview {name}: camera slots")
        rv1, tv1 = poses[1]
        rot_err = rotation_angle_deg(rodrigues_np(m.rvecs[1].cpu().numpy()), rodrigues_np(rv1))
        t_est = m.tvecs[1].cpu().numpy().astype(np.float64)
        dir_err = float(np.degrees(np.arccos(np.clip(
            t_est @ tv1 / np.linalg.norm(t_est) / np.linalg.norm(tv1), -1, 1))))
        # Landmarks: the map keeps up to B of the true inliers.
        true_inl = arrays[0]["keypoints"]["valid"] & arrays[1]["keypoints"]["valid"]
        true_inl[:n_out] = False
        kept = int(m.pt_valid.sum())
        used = res["used_a"].cpu().numpy()
        possible = min(B, int(true_inl.sum()))
        check(kept >= 0.8 * possible and int(used.sum()) == kept,
              f"twoview {name}: kept {kept} landmarks of {possible} possible")
        check(int((used & true_inl).sum()) >= 0.99 * kept,
              f"twoview {name}: {int((used & ~true_inl).sum())} kept landmarks are not true "
              f"inliers")
        zero = torch.zeros(3, device=dev)
        e0 = tgeo.reprojection_error(tgeo.Camera(zero, zero), m.points[:B], m.obs.uv[:B],
                                     res["K"])
        e1 = tgeo.reprojection_error(tgeo.Camera(m.rvecs[1], m.tvecs[1]), m.points[:B],
                                     m.obs.uv[B:2 * B], res["K"])
        err = torch.maximum(e0, e1)[m.pt_valid[:B]]
        return rot_err, dir_err, kept, int(true_inl.sum()), float(err.median()), float(err.max())

    # The narrow scene: readings at the geometry of tests/test_sfm.py.
    arrays, poses, k_np, n_out = twoview_scene(TV_NARROW)
    narrow = against_truth("narrow", run(arrays, k_np, dev, third=False), arrays, poses, n_out)
    check(narrow[0] < 2.0 and narrow[1] < 30.0,
          f"twoview narrow: rotation {narrow[0]:.3f} deg, direction {narrow[1]:.3f} deg")

    arrays, poses, k_np, n_out = twoview_scene(TV_WIDE)
    gpu = run(arrays, k_np, dev)
    torch.cuda.synchronize()
    m = gpu["m"]
    rot_err, dir_err, kept, n_true, median, worst = against_truth(
        "wide", gpu, arrays, poses, n_out)
    check(rot_err < 1.0, f"twoview: rotation {rot_err:.3f} deg from the truth")
    check(dir_err < 3.0, f"twoview: translation direction {dir_err:.3f} deg from the truth")
    check(worst < 2.0 and median < TV_MEDIAN_REPROJ_PX,
          f"twoview: landmark reprojection error median {median:.3f}, worst {worst:.3f} px")
    tv1 = poses[1][1]
    # Third view by PnP against those landmarks.
    rv2, tv2 = poses[2]
    scale = 1.0 / np.linalg.norm(tv1)
    cam = gpu["cam"]
    pnp_rot = rotation_angle_deg(rodrigues_np(cam.rvec.cpu().numpy()), rodrigues_np(rv2))
    pnp_t = float(np.linalg.norm(cam.tvec.cpu().numpy() - tv2 * scale)
                  / np.linalg.norm(tv2 * scale))
    check(pnp_rot < 1.0 and pnp_t < 0.02,
          f"twoview: PnP pose {pnp_rot:.3f} deg, {pnp_t:.4f} of |t| from the truth")
    # The port's CPU run under the same draws.
    cpu = run(arrays, k_np, "cpu", idx=gpu["idx"].cpu(), pnp_idx=gpu["pnp_idx"].cpu())
    check(torch.equal(cpu["m"].cam_valid, m.cam_valid.cpu()), "twoview: cam_valid, card vs CPU")
    pt_diff = float((cpu["m"].pt_valid != m.pt_valid.cpu()).float().mean())
    check(pt_diff < 0.01, f"twoview: pt_valid of card and CPU differ in {pt_diff:.4f} of slots")
    pose_diff = max(float((cpu["m"].rvecs - m.rvecs.cpu()).abs().max()),
                    float((cpu["m"].tvecs - m.tvecs.cpu()).abs().max()))
    check(pose_diff < 1e-3, f"twoview: pose of card and CPU differ by {pose_diff:.2e}")
    f, K = gpu["f"], gpu["K"]
    E = tgeo.essential_from_fundamental(
        tm.ransac_fundamental(None, gpu["p0"], gpu["p1"], gpu["pair_ok"], 512,
                              sample_idx=gpu["idx"]).model, K)
    times = {
        "match_descriptors": call_times(torch, lambda: tm.match_descriptors(
            f[0].descriptors, f[1].descriptors, f[0].keypoints.valid, f[1].keypoints.valid)),
        "ransac_fundamental": call_times(torch, lambda: tm.ransac_fundamental(
            seeded(), gpu["p0"], gpu["p1"], gpu["pair_ok"], 512)),
        "recover_pose": call_times(torch, lambda: tgeo.recover_pose(
            E, gpu["p0"], gpu["p1"], K, gpu["pair_ok"])),
        "init_two_view": call_times(torch, lambda: sfm.init_two_view(
            seeded(), f[0], f[1], K, gpu["m0"], B)),
        "ransac_pnp": call_times(torch, lambda: sfm.ransac_pnp(
            seeded(), m.points, gpu["pts2d"], gpu["pnp_mask"], K, 128)),
    }
    phase("twoview", f"{TV_SLOTS} slots/frame, {n_out} outliers, {TV_NOISE_PX} px noise, 512 "
          f"hypotheses; {TV_NARROW[0]}x{TV_NARROW[1]} f={TV_NARROW[2]:.0f} baseline 0.35 (the "
          f"scene of tests/test_sfm.py): rotation {narrow[0]:.3f} deg, translation direction "
          f"{narrow[1]:.3f} deg, {narrow[2]} landmarks of {narrow[3]} true inliers, reprojection "
          f"median {narrow[4]:.3f} px, worst {narrow[5]:.3f}; {TV_WIDE[0]}x{TV_WIDE[1]} "
          f"f={TV_WIDE[2]:.0f} baseline 1.5: rotation {rot_err:.3f} deg and translation "
          f"direction {dir_err:.3f} deg "
          f"from the truth; {kept} landmarks kept of {n_true} true inliers "
          f"(capacity {B}), reprojection median {median:.3f} px (gate {TV_MEDIAN_REPROJ_PX}), "
          f"worst {worst:.3f} (init_two_view's own gate 2); PnP of view 3 (128 hypotheses): "
          f"{int(gpu['n_inl'])} inliers of {int(gpu['pnp_mask'].sum())}, {pnp_rot:.3f} deg, "
          f"{pnp_t:.4f} of |t|; CPU with the same draws: pt_valid differ in {pt_diff:.4f} of "
          f"slots, pose by {pose_diff:.2e}; " + fmt_times(times))


def sfm_scene(n_frames, seed=0, step=(-0.35, 0.02, 0.05)):
    """(numpy feature dicts, true rvecs, tvecs, intrinsics) of the sfm
    phases' scene (see SFM_FRAMES), the camera moving by ``step`` a frame."""
    from sift_parallel_optimization_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    k_np = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)
    pts, descs = synthetic.landmarks(rng, SFM_LANDMARKS, *SFM_BOX)
    rv, tv = synthetic.out_and_back(n_frames, step=step, yaw=0.01, past=1 - n_frames % 2)
    feats = [synthetic.view_features(rng, pts, descs, rv[i], tv[i], k_np, 400, 300, SFM_SLOTS,
                                     compact=True) for i in range(n_frames)]
    return feats, rv, tv, k_np


def loops_written(m, n_frames, pts_per_frame) -> int:
    """Accepted loop closures: the loop blocks of the map's observations
    that hold an observation."""
    tail = m.obs.valid[3 * n_frames * pts_per_frame:]
    return int(tail.reshape(-1, pts_per_frame).any(dim=1).sum())


def sfm_ate(torch, m, rv, tv) -> tuple[float, float]:
    """(ATE after Sim(3) alignment, the true trajectory's span)."""
    from sift_parallel_optimization_tpu_torch.utils.trajectory import ate_rmse, camera_centers

    gt = camera_centers(torch.from_numpy(rv), torch.from_numpy(tv)).to(m.rvecs.device)
    span = float(np.linalg.norm(np.ptp(gt.cpu().numpy(), axis=0)))
    return float(ate_rmse(camera_centers(m.rvecs, m.tvecs), gt)), span


def sfm_phase(torch, dev):
    """run_sfm on SFM_FRAMES keyframes of the synthetic scene on the card,
    against the scene's truth; then one register_frame, one mid-run BA and
    the final BA timed on the resulting map (host clock and device)."""
    from sift_parallel_optimization_tpu_torch.models import ba, sfm
    from sift_parallel_optimization_tpu_torch.models.frontend import features_from_numpy
    from sift_parallel_optimization_tpu_torch.models.matching import match_descriptors
    from sift_parallel_optimization_tpu_torch.utils.profiling import device_breakdown

    arrays, rv, tv, k_np = sfm_scene(SFM_FRAMES)
    feats = [features_from_numpy(a, device=dev) for a in arrays]
    K = torch.from_numpy(k_np).to(dev)
    n, B = SFM_FRAMES, SFM_PTS_PER_FRAME
    solver = ba.resolve_solver(n, n * B, "auto")
    check(solver == "cg", f"sfm: 'auto' chose {solver!r} at {n} frames x {B} landmarks")
    walls = []
    for _ in range(2):       # the first run pays one-time set-up; the second is warm
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = sfm.run_sfm(gen, feats, K, pts_per_frame=B)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    run_s = walls[1]
    # One PnP RANSAC a registration (frames 2..n-1) and a loop proposal a
    # frame from loop_min_gap + 2 = 7 on.
    pnp_calls = (n - 2) + (n - 7)
    n_cams = int(m.cam_valid.sum())
    loops = loops_written(m, n, B)
    rms = float(ba.rms_error(m.ba_state(), m.obs, K))
    ate, span = sfm_ate(torch, m, rv, tv)
    check(n_cams == n, f"sfm: {n_cams}/{n} cameras registered")
    check(loops >= 1, "sfm: no loop closure was accepted")
    check(rms < SFM_RMS_PX, f"sfm: reprojection RMS {rms:.3f} px")
    check(ate <= SFM_ATE_FRAC * span, f"sfm: ATE {ate:.4f} over a span of {span:.3f}")
    for t in (m.rvecs, m.tvecs, m.points):
        check(bool(torch.isfinite(t).all()), "sfm: non-finite map entries")

    # CG iterations a GN step, from the final map and from a start moved off
    # it (the masked loop always runs cg_iters trips; these are the trips
    # that changed the update).
    max_obs = -(-(n + 8) // 8) * 8
    plan = ba.make_group_plan(m.obs, n, n * B, max_obs)
    iters = {}
    for name, st in (("final map", m.ba_state()),
                     ("moved", m.ba_state()._replace(points=m.points + 0.01))):
        blk = ba.assemble_implicit_blocks(st, m.obs, K, 1e-4, 2.0, plan=plan)
        iters[name] = int(ba.schur_pcg(blk)[1])
    check(int(plan.n_dropped) == 0, f"sfm: the CG plan dropped {int(plan.n_dropped)} obs")

    # One registration, one mid-run BA (5 GN steps) and the final BA (15),
    # on the map the run produced: the same shapes the run gave them.
    used = torch.zeros(SFM_SLOTS, dtype=torch.bool, device=dev)
    kw = dict(damping=1e-4, huber_delta=2.0, solver="cg", max_obs_per_point=max_obs)
    last = feats[n - 1]
    m3 = match_descriptors(last.descriptors, m.pt_desc, last.keypoints.valid, m.pt_valid)
    uv = torch.stack([last.keypoints.x, last.keypoints.y], -1)
    calls = {
        "register_frame": lambda: sfm.register_frame(gen, m, last, feats[n - 2], n - 1, K, used,
                                                     B),
        "ransac_pnp": lambda: sfm.ransac_pnp(gen, m.points[m3.idx2], uv,
                                             m3.valid & m.pt_valid[m3.idx2], K),
        "mid BA (5 steps)": lambda: ba.bundle_adjust(m.ba_state(), m.obs, K, n_iters=5, **kw),
        "final BA (15 steps)": lambda: ba.bundle_adjust(m.ba_state(), m.obs, K, n_iters=15,
                                                        **kw),
    }
    times = {name: call_times(torch, fn, iters=3, warmup=1, profiled=2)
             for name, fn in calls.items()}
    _ms, top = device_breakdown(calls["mid BA (5 steps)"], warmup=0, iters=1, top=6)
    pnp_ms = times["ransac_pnp"][0]
    share = pnp_calls * pnp_ms / 1e3 / run_s
    phase("sfm", f"run_sfm {n} keyframes, {B} landmarks/frame, {SFM_SLOTS} slots/frame, "
          f"{SFM_LANDMARKS} scene landmarks: solver {solver} (auto), cameras {n_cams}/{n}, "
          f"loops accepted {loops}, landmarks {int(m.pt_valid.sum())}, observations "
          f"{int(m.obs.valid.sum())}, reprojection RMS {rms:.4f} px (gate {SFM_RMS_PX}), ATE "
          f"{ate:.5f} = {100 * ate / span:.3f}% of span {span:.3f} (gate "
          f"{100 * SFM_ATE_FRAC:.0f}%); run {run_s:.3f} s wall warm ({run_s / n * 1e3:.1f} "
          f"ms/frame; first run {walls[0]:.3f} s); "
          f"CG iterations a GN step (of 25): final map {iters['final map']}, moved "
          f"{iters['moved']}; {pnp_calls} ransac_pnp calls x {pnp_ms:.3f} ms = "
          f"{100 * share:.1f}% of the run; " + fmt_times(times)
          + "; mid BA device time by kernel (ms/call, launches/call): " + "; ".join(
              f"{name[:60]} {ms:.3f} ({cnt})" for name, ms, cnt in top))
    return m, feats, K


def pose_graph_scene(n, loop_span, loop_every, per_edge_scale=1.0, noise=0.0, seed=3):
    """(truth, drifted start, Sim3Edges fields) as numpy arrays, with metric
    loops (i -> i + loop_span) every ``loop_every`` nodes: see PGO_NODES."""
    import torch

    from sift_parallel_optimization_tpu_torch.models.geometry import rotation_log
    from sift_parallel_optimization_tpu_torch.models.pose_graph import relative_pose

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi * n / 200, n)
    gt_t = np.stack([np.cos(th), np.sin(th), 0.05 * rng.normal(size=n)], 1).astype(np.float32)
    gt_r = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    rel = lambda r0, t0, r1, t1: [a.numpy() for a in relative_pose(*map(
        torch.from_numpy, (r0, t0, r1, t1)))]
    rr, rt = rel(gt_r[:-1], gt_t[:-1], gt_r[1:], gt_t[1:])
    rt = rt * (1.0 + noise * rng.normal(size=(n - 1, 1))).astype(np.float32)
    est_r, est_t, s = [gt_r[0].astype(np.float64)], [gt_t[0].astype(np.float64)], 1.0
    for k in range(n - 1):
        s *= per_edge_scale
        R_rel = rodrigues_np(rr[k])
        est_t.append(R_rel @ est_t[-1] + s * rt[k])
        est_r.append(R_rel @ rodrigues_np(est_r[-1]))
        est_r[-1] = rotation_log(torch.from_numpy(est_r[-1].astype(np.float32))).numpy()
    est_r, est_t = np.stack(est_r).astype(np.float32), np.stack(est_t).astype(np.float32)
    cr, ct = rel(est_r[:-1], est_t[:-1], est_r[1:], est_t[1:])
    li = np.asarray(list(range(0, n - loop_span, loop_every)) + [n - loop_span - 1], np.int32)
    lr, lt = rel(gt_r[li], gt_t[li], gt_r[li + loop_span], gt_t[li + loop_span])
    L = len(li)
    edges = dict(i=np.concatenate([np.arange(n - 1), li]).astype(np.int32),
                 j=np.concatenate([np.arange(1, n), li + loop_span]).astype(np.int32),
                 rel_rvec=np.concatenate([cr, lr]), rel_tvec=np.concatenate([ct, lt]),
                 rel_log_s=np.zeros(n - 1 + L, np.float32),
                 weight=np.concatenate([np.ones(n - 1), np.full(L, 8.0)]).astype(np.float32),
                 metric=np.concatenate([np.zeros(n - 1), np.ones(L)]).astype(np.float32))
    return (gt_r, gt_t), (est_r, est_t), edges


def pgo_phase(torch, dev):
    """The SE(3) and Sim(3) solvers on the card: CG and chain against dense
    at PGO_NODES nodes, the 1,000-node Sim(3) scale ramp through the chain
    solver; ms per GN step, device ms and launches (see PGO_NODES)."""
    from sift_parallel_optimization_tpu_torch.models import pose_graph as pg
    from sift_parallel_optimization_tpu_torch.models import pose_graph_sim3 as ps
    from sift_parallel_optimization_tpu_torch.utils.trajectory import ate_rmse, camera_centers

    (_gt_r, _gt_t), (er, et), edges = pose_graph_scene(PGO_NODES, PGO_NODES // 2,
                                                       PGO_LOOP_EVERY, noise=PGO_NOISE)
    cap = int((edges["j"] != edges["i"] + 1).sum())
    s_edges = ps.sim3_edges_from_numpy(edges, dev)
    s_poses = ps.se3_to_sim3_poses(torch.from_numpy(er).to(dev), torch.from_numpy(et).to(dev))
    graphs = {
        "SE(3)": (pg.pgo_step, pg.Poses(s_poses.rvecs, s_poses.tvecs),
                  pg.PoseGraphEdges(*s_edges[:4], s_edges.weight)),
        "Sim(3)": (ps.sim3_step, s_poses, s_edges),
    }
    kw = dict(damping=1e-4, cg_iters=PGO_CG_ITERS, cg_tol=1e-12, offchain_cap=cap)
    lines, worst = [], {}
    for name, (step, poses, e) in graphs.items():
        dense = step(poses, e, solver="dense", **kw)
        rms0 = float((ps.sim3_rms if name == "Sim(3)" else pg.pgo_rms)(poses, e))
        for solver in ("chain", "cg"):
            got = step(poses, e, solver=solver, **kw)
            for g, d in zip(got, dense):
                check(bool(torch.allclose(g, d, rtol=PGO_RTOL, atol=PGO_ATOL)),
                      f"pgo: {name} {solver} step vs dense: {max_err([g], [d]):.3e}")
            worst[f"{name} {solver}"] = max_err(got, dense)
        times = {solver: call_times(torch, lambda: step(poses, e, solver=solver, **kw), iters=2,
                                    warmup=1, profiled=1)
                 for solver in ("dense", "chain", "cg")}
        lines.append(f"{name} {PGO_NODES} nodes, {cap} loop edges, start rms {rms0:.4f}: "
                     f"one GN step vs dense, max abs diff chain {worst[name + ' chain']:.2e}, CG "
                     f"({PGO_CG_ITERS} trips) {worst[name + ' cg']:.2e} (rtol/atol "
                     f"{PGO_RTOL}); a GN step: " + fmt_times(times))

    # The thousand-node scale ramp through "auto" -> chain.
    n = RAMP_NODES
    (gt_r, gt_t), (er, et), edges = pose_graph_scene(n, 200, 100, np.exp(np.log(1.5) / (n - 1)))
    cap = int((edges["j"] != edges["i"] + 1).sum())
    check(ps.resolve_sim3_solver(n, offchain_cap=cap) == "chain", "pgo: ramp not on the chain")
    e = ps.sim3_edges_from_numpy(edges, dev)
    p0 = ps.se3_to_sim3_poses(torch.from_numpy(er).to(dev), torch.from_numpy(et).to(dev))
    damping = ps.chain_damping(n, 1e-4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ps.optimize_sim3_graph(p0, e, n_iters=12, damping=damping, offchain_cap=cap)
    torch.cuda.synchronize()
    ramp_s = time.perf_counter() - t0
    rv, tv = ps.sim3_to_se3_poses(out)
    gt = camera_centers(torch.from_numpy(gt_r), torch.from_numpy(gt_t)).to(dev)
    ate = lambda r, t: float(ate_rmse(camera_centers(r, t), gt, with_scale=False))
    ate0, ate1 = ate(p0.rvecs, p0.tvecs), ate(rv, tv)
    ls = out.log_s.cpu().numpy()
    ramp = np.log(1.5) * np.arange(n) / (n - 1)
    corr = float(np.corrcoef(ls, ramp)[0, 1])
    check(ate1 < RAMP_ATE_FRAC * ate0, f"pgo: ramp ATE {ate1:.4f} vs drifted {ate0:.4f}")
    check(abs(ls[-1] - ramp[-1]) < RAMP_LS_ATOL, f"pgo: ramp log_s[-1] {ls[-1]:.4f}")
    check(corr > RAMP_CORR, f"pgo: ramp log_s correlation {corr:.4f}")
    step_t = call_times(torch, lambda: ps.sim3_step(p0, e, damping, solver="chain",
                                                    offchain_cap=cap),
                        iters=1, warmup=0, profiled=1)
    lines.append(f"Sim(3) scale ramp {n} nodes, {cap} metric loops, chain solver: 12 GN steps "
                 f"{ramp_s:.3f} s; ATE {ate0:.4f} -> {ate1:.4f} ({ate1 / ate0:.3f}x, gate "
                 f"{RAMP_ATE_FRAC}), log_s[-1] {ls[-1]:.4f} vs {ramp[-1]:.4f}, correlation "
                 f"{corr:.5f}; a GN step " + fmt_times({"chain": step_t}))
    phase("pgo", "; ".join(lines))


def odometry_frames(torch, dev):
    """tests/test_long_sequence.py's rendered triangle-wave sequence:
    (frames (n, size, size) on ``dev``, K, true rvecs, true tvecs)."""
    from sift_parallel_optimization_tpu_torch.utils import native

    half = ODO_PERIOD // 2
    ks = [(i % ODO_PERIOD) if (i % ODO_PERIOD) <= half else ODO_PERIOD - (i % ODO_PERIOD)
          for i in range(ODO_FRAMES)]
    gt_r = np.stack([[0.0, 0.025 * k, 0.002 * k] for k in ks]).astype(np.float32)
    gt_t = np.stack([[-0.25 * k, 0.012 * k, 0.035 * k] for k in ks]).astype(np.float32)
    f = float(ODO_SIZE)
    imgs = np.stack([native._render_frame_numpy(ODO_SIZE, gt_r[i], gt_t[i], f, ODO_SEED)
                     for i in range(ODO_FRAMES)])
    K = torch.tensor([[f, 0, ODO_SIZE / 2], [0, f, ODO_SIZE / 2], [0, 0, 1.0]], device=dev)
    return torch.from_numpy(imgs).to(dev), K, gt_r, gt_t


def odometry_features(torch, dev, imgs):
    """The sequence through the batched frontend, ODO_BATCH frames a call:
    a list of per-frame Features."""
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config

    fe = SiftFrontend(sift_config(ODO_SIZE), max_keypoints=ODO_KEYPOINTS, dual_orientation=True,
                      device=dev)
    out = [fe(imgs[b:b + ODO_BATCH]) for b in range(0, imgs.shape[0], ODO_BATCH)]
    return [frame_of(o, i) for o in out for i in range(o.descriptors.shape[0])]


class StepClock:
    """Times every call of ``SteadyStepRunner.run`` (the steady step of
    ``run_odometry``) between CUDA events, and keeps each run's runner: a
    wrapper around the method while the phase runs. ``kind`` of a call:
    "eager" (graph=False), "warm" (a variant's first frame, eager on a side
    stream), "capture" (its second, captured then replayed) or "replay"."""

    def __init__(self, torch, odo):
        self.torch, self.cls, self.calls, self.runners = torch, odo.SteadyStepRunner, [], []
        self.orig = self.cls.run
        clock = self

        def run(runner, i, do_ba, do_loop, **kw):
            if not clock.runners or clock.runners[-1] is not runner:
                clock.runners.append(runner)
            key = (do_ba, do_loop)
            kind = ("eager" if not runner.graph else "replay" if key in runner.graphs
                    else "capture" if key in runner.warm else "warm")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            clock.orig(runner, i, do_ba, do_loop, **kw)
            end.record()
            clock.calls.append((runner, kind, do_ba, start, end, time.perf_counter() - t0))

        self.cls.run = run

    def close(self):
        self.cls.run = self.orig

    def summary(self, runner):
        """{kind: (median ms between events, median host ms, calls)} of one run."""
        self.torch.cuda.synchronize()
        out = {}
        for kind in ("eager", "warm", "capture", "replay"):
            rows = [(s.elapsed_time(e), h * 1e3) for r, k, _b, s, e, h in self.calls
                    if r is runner and k == kind]
            if rows:
                out[kind] = (float(np.median([a for a, _ in rows])),
                             float(np.median([b for _, b in rows])), len(rows))
        return out


def odometry_phase(torch, dev, counters):
    """tests/test_long_sequence.py's 120-frame three-cycle revisit through
    the batched frontend and run_odometry on the card, its steady step as
    CUDA graphs (see ODO_FRAMES). Returns the kernels' launches during the
    frontend's run (the path's own count)."""
    from sift_parallel_optimization_tpu_torch.models import odometry as odo
    from sift_parallel_optimization_tpu_torch.utils.profiling import profile_device
    from sift_parallel_optimization_tpu_torch.utils.trajectory import ate_rmse, camera_centers

    imgs, K, gt_r, gt_t = odometry_frames(torch, dev)
    feats, launches = counted(torch, counters, lambda: odometry_features(torch, dev, imgs))
    check(len(feats) == ODO_FRAMES and feats[0].descriptors.shape == (2 * ODO_KEYPOINTS, 128),
          "odometry: feature shapes")
    n_kp = [int(f.keypoints.count()) for f in feats]
    gt = camera_centers(torch.from_numpy(gt_r), torch.from_numpy(gt_t)).to(dev)
    span = float(np.linalg.norm(np.ptp(gt.cpu().numpy(), axis=0)))
    W, B = ODO_WINDOW, ODO_PTS_PER_FRAME
    configs = {
        "windowed": dict(),
        "fifo": dict(loop_closure=True),
        "coverage": dict(loop_closure=True, archive_size=ODO_COV_BLOCKS * B,
                         archive_policy="coverage"),
    }
    clock = StepClock(torch, odo)
    tap = CorrectionTap(odo)
    res = {}
    try:
        for name, kw in configs.items():
            gen = torch.Generator(device=dev).manual_seed(ODO_DRAW_SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj, m, info = odo.run_odometry(gen, feats, K, window=W, pts_per_frame=B,
                                             return_info=True, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(bool(torch.isfinite(traj.rvecs).all() & torch.isfinite(traj.tvecs).all()),
                  f"odometry {name}: non-finite poses")
            check(traj.rvecs.shape == (ODO_FRAMES, 3), f"odometry {name}: trajectory shape")
            check(m.rvecs.shape[0] == W and m.points.shape[0] == W * B
                  and m.obs.uv.shape[0] == 3 * W * B, f"odometry {name}: capacities not O(window)")
            ate = float(ate_rmse(camera_centers(traj.rvecs, traj.tvecs), gt))
            res[name] = (ate, info, wall, clock.runners[-1])
            if name == "fifo":
                fifo = {"traj": traj, "info": info, "raw": tap.calls[-1][0]}
        # The same generator through the eager and the captured step, on a
        # prefix with loop closure.
        prefix = {}
        for graph in (False, True):
            gen = torch.Generator(device=dev).manual_seed(ODO_DRAW_SEED)
            prefix[graph] = odo.run_odometry(gen, feats[:ODO_PREFIX], K, window=W,
                                             pts_per_frame=B, loop_closure=True, graph=graph,
                                             return_info=True)
            prefix[graph] += (clock.runners[-1],)
        eager_runner = prefix[False][3]
        # Device ms and launches of one eager steady step of each variant (on
        # the prefix run's final carry; the shapes are the run's).
        step_prof = {}
        gen = torch.Generator(device=dev).manual_seed(0)
        for do_ba in (False, True):
            ops, dms, _prof = profile_device(
                lambda: clock.orig(eager_runner, ODO_PREFIX - 1, do_ba, True, generator=gen),
                warmup=0, iters=1)
            step_prof[do_ba] = (ops, dms)
    finally:
        clock.close()
        tap.close()

    (w_ate, w_info, w_wall, _r), (f_ate, f_info, f_wall, f_runner), (c_ate, c_info, c_wall, _c) = (
        res["windowed"], res["fifo"], res["coverage"])
    check(len(f_info["loop_frames"]) >= ODO_MIN_LOOPS,
          f"odometry fifo: {len(f_info['loop_frames'])} loops accepted")
    check(f_info["loops_dropped"] == 0 and c_info["loops_dropped"] == 0, "odometry: loops dropped")
    check(f_ate < ODO_ATE_FRAC * span, f"odometry fifo: ATE {f_ate:.4f} over a span of {span:.3f}")
    check(f_ate * ODO_GAIN < w_ate, f"odometry fifo: ATE {f_ate:.4f} vs windowed {w_ate:.4f}")
    check(len(c_info["loop_frames"]) >= ODO_COV_MIN_LOOPS,
          f"odometry coverage: {len(c_info['loop_frames'])} loops accepted")
    check(c_ate < ODO_COV_ATE_FRAC * span,
          f"odometry coverage: ATE {c_ate:.4f} over a span of {span:.3f}")
    check(f_info["graph_replays"] > 0 and f_runner.graph and len(f_runner.graphs) >= 2,
          "odometry: the steady step did not replay captured graphs")
    (e_traj, _em, e_info, _er), (g_traj, _gm, g_info, g_runner) = prefix[False], prefix[True]
    d_r = float((g_traj.rvecs - e_traj.rvecs).abs().max())
    d_t = float((g_traj.tvecs - e_traj.tvecs).abs().max())
    check(d_r <= ODO_GRAPH_ATOL and d_t <= ODO_GRAPH_ATOL and g_info["graph_replays"] > 0
          and g_info["loop_frames"] == e_info["loop_frames"] and e_info["loop_frames"],
          f"odometry: graph vs eager step on {ODO_PREFIX} frames: rotations {d_r:.3e}, "
          f"translations {d_t:.3e}, loops {g_info['loop_frames']} vs {e_info['loop_frames']}")
    full = clock.summary(f_runner)
    eager, graph = clock.summary(eager_runner), clock.summary(g_runner)
    n_steady = ODO_FRAMES - W
    ba_share = sum(1 for i in range(W, ODO_FRAMES) if i % 2 == 0 or i == ODO_FRAMES - 1) / n_steady
    dev_ms = ba_share * step_prof[True][1] + (1 - ba_share) * step_prof[False][1]
    rep_ms = full["replay"][0]
    eager_ms = eager["eager"][0]
    fmt = lambda d: ", ".join(f"{k} {a:.3f} ms (host {h:.3f} ms, n={c})"
                              for k, (a, h, c) in d.items())
    phase("odometry", f"{ODO_FRAMES} frames {ODO_SIZE}^2 (three-cycle revisit, period "
          f"{ODO_PERIOD}), batched frontend (B={ODO_BATCH}, {ODO_KEYPOINTS} keypoints, dual "
          f"orientations: {2 * ODO_KEYPOINTS} slots; {min(n_kp)}..{max(n_kp)} valid a frame), "
          f"W={W}, {B} landmarks/frame, span {span:.3f}: windowed-only ATE {w_ate:.5f} "
          f"({100 * w_ate / span:.3f}%, {w_wall:.3f} s); FIFO 64 blocks ATE {f_ate:.5f} "
          f"({100 * f_ate / span:.3f}%, gate {100 * ODO_ATE_FRAC:.0f}%; "
          f"{w_ate / f_ate:.2f}x better, gate {ODO_GAIN}x), loops {f_info['loop_frames']} "
          f"(inliers {f_info['loop_inliers']}), {f_wall:.3f} s; coverage {ODO_COV_BLOCKS} "
          f"blocks ATE {c_ate:.5f} ({100 * c_ate / span:.3f}%, gate "
          f"{100 * ODO_COV_ATE_FRAC:.1f}%), {len(c_info['loop_frames'])} loops "
          f"{c_info['loop_frames']}, {c_wall:.3f} s; dropped 0; graph vs eager step on "
          f"{ODO_PREFIX} frames: rotations {d_r:.2e}, translations {d_t:.2e} (atol "
          f"{ODO_GRAPH_ATOL}), loops {g_info['loop_frames']}; steady step a frame "
          f"(CUDA events): FIFO run {fmt(full)}; prefix graph {fmt(graph)}; prefix eager "
          f"{fmt(eager)}; device per eager step: without BA {step_prof[False][1]:.3f} ms in "
          f"{step_prof[False][0]:.0f} launches, with BA {step_prof[True][1]:.3f} ms in "
          f"{step_prof[True][0]:.0f} launches ({100 * ba_share:.0f}% of steady frames run the "
          f"BA: {dev_ms:.3f} device ms a frame); a replay is one graph launch; busy share "
          f"graph {100 * dev_ms / rep_ms:.1f}%, eager {100 * dev_ms / eager_ms:.1f}%; "
          f"{len(f_runner.graphs)} graphs captured")
    return launches, feats, K, fifo


class CorrectionTap:
    """Keeps (input trajectory, output trajectory) of every call of
    ``models/odometry.correct_trajectory`` (the end-of-run pose-graph
    correction) while open."""

    def __init__(self, odo):
        self.odo, self.orig, self.calls = odo, odo.correct_trajectory, []

        def tapped(traj, *args, **kw):
            out = self.orig(traj, *args, **kw)
            self.calls.append((traj, out, args, kw))
            return out

        odo.correct_trajectory = tapped

    def close(self):
        self.odo.correct_trajectory = self.orig


def traj_diff(a, b) -> tuple[float, float]:
    return (float((a.rvecs - b.rvecs).abs().max()), float((a.tvecs - b.tvecs).abs().max()))


def stream_equiv_phase(torch, dev, feats, K, fifo):
    """OdometryStream over the odometry phase's 120 features, pushed one at
    a time, against that phase's FIFO run_odometry run (see
    STREAM_EQUIV_ATOL)."""
    from sift_parallel_optimization_tpu_torch.models import odometry as odo

    n, W = len(feats), ODO_WINDOW
    max_loops = max(8, (n - W) // (3 + 1) + 1)      # run_odometry's pick for this n
    gen = torch.Generator(device=dev).manual_seed(ODO_DRAW_SEED)
    tap = CorrectionTap(odo)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream = odo.OdometryStream(gen, K, window=W, pts_per_frame=ODO_PTS_PER_FRAME,
                                    loop_closure=True, max_loops=max_loops)
        for f in feats:
            stream.push(f)
        traj, _m, info = stream.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tap.close()
    check(len(tap.calls) == 1, f"stream_equiv: {len(tap.calls)} end-of-run corrections")
    raw, _out, args, kw = tap.calls[0]
    # The same correction once more on the same input: how far the end-of-run
    # PGO moves between two runs on the card.
    again = tap.orig(raw, *args, **kw)
    b_traj, b_info, b_raw = fifo["traj"], fifo["info"], fifo["raw"]
    d_r, d_t = traj_diff(traj, b_traj)
    check(info["loop_frames"] == b_info["loop_frames"],
          f"stream_equiv: loops {info['loop_frames']} vs run_odometry's {b_info['loop_frames']}")
    raw_r, raw_t = traj_diff(raw, b_raw)
    rep_r, rep_t = traj_diff(again, traj)
    check(info["graph_replays"] > 0 and info["loops_dropped"] == 0,
          f"stream_equiv: {info['graph_replays']} replays, {info['loops_dropped']} dropped")
    check(max(raw_r, raw_t) <= STREAM_EQUIV_ATOL,
          f"stream_equiv: before the correction rotations differ by {raw_r:.3e}, translations "
          f"by {raw_t:.3e} (atol {STREAM_EQUIV_ATOL})")
    check(max(d_r, d_t) <= STREAM_EQUIV_ATOL,
          f"stream_equiv: corrected rotations differ by {d_r:.3e}, translations by {d_t:.3e} "
          f"(atol {STREAM_EQUIV_ATOL}; before the correction {raw_r:.3e} / {raw_t:.3e}; the "
          f"same correction run twice: {rep_r:.3e} / {rep_t:.3e})")
    phase("stream_equiv", f"OdometryStream over the odometry phase's {n} features (FIFO, "
          f"W={W}, draws seeded {ODO_DRAW_SEED}, max_loops {max_loops} on both sides) vs "
          f"run_odometry: loops {info['loop_frames']} (equal), largest difference before the "
          f"correction: rotations {raw_r:.3e}, translations {raw_t:.3e}; after it: "
          f"{d_r:.3e} / {d_t:.3e} (atol {STREAM_EQUIV_ATOL}); the same correction run twice: "
          f"{rep_r:.3e} / {rep_t:.3e}; {info['graph_replays']} replays, {wall:.3f} s "
          f"(frontend excluded)")


class ServeTap:
    """Wraps ``FrameLoader.next_frame``, ``cli.upload_frame``,
    ``SiftFrontend.forward`` and ``OdometryStream.push`` while open: CUDA
    events and the host clock around each call, the push's kind ("fill":
    frames before the window is full, "warm", "capture", "replay"), and host
    syncs. Loads, uploads and pushes that replay a captured step run under
    ``torch.cuda.set_sync_debug_mode("error")`` (a sync raises); the rest
    under "warn", their sync warnings counted by kind (the frontend's first
    call, the warm-up frame, apart: it builds the shape's cached tables)."""

    def __init__(self, torch, odo, frontend_cls, cli, native):
        self.torch, self.calls, self.syncs = torch, [], {}
        self.targets = ((native.FrameLoader, "next_frame"), (cli, "upload_frame"),
                        (frontend_cls, "forward"), (odo.OdometryStream, "push"))
        self.origs = [getattr(c, a) for c, a in self.targets]
        o_load, o_up, o_fwd, o_push = self.origs
        tap = self

        def timed(kind, fn, strict):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error" if strict else "warn")
            try:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    out = fn()
            except RuntimeError as e:
                raise SmokeFailure(f"stream: a {kind} call synchronized with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            end.record()
            tap.calls.append([kind, start, end, time.perf_counter() - t0, t0])
            n_sync = sum("synchroniz" in str(w.message) for w in seen)
            if n_sync:
                tap.syncs[kind] = tap.syncs.get(kind, 0) + n_sync
            return out

        def push(stream, feats):
            i, r = stream.frames, stream.runner
            if r is not None and r.graph and stream.variant(i) in r.graphs:
                return timed("replay", lambda: o_push(stream, feats), strict=True)
            state = lambda r: (len(r.warm), len(r.graphs)) if r is not None else (0, 0)
            before = state(r)
            out = timed("push", lambda: o_push(stream, feats), strict=False)
            r, after = stream.runner, state(stream.runner)
            kind = ("fill" if r is None else "capture" if after[1] > before[1]
                    else "warm" if after[0] > before[0] else "eager")
            tap.calls[-1][0] = kind
            if "push" in tap.syncs:
                tap.syncs[kind] = tap.syncs.get(kind, 0) + tap.syncs.pop("push")
            return out

        def forward(fe, img):
            first = not any(c[0] == "frontend first" for c in tap.calls)
            return timed("frontend first" if first else "frontend", lambda: o_fwd(fe, img),
                         strict=False)

        wrappers = (lambda ld: timed("load", lambda: o_load(ld), strict=True),
                    lambda frame, dev: timed("upload", lambda: o_up(frame, dev), strict=True),
                    forward, push)
        for (cls, attr), fn in zip(self.targets, wrappers):
            setattr(cls, attr, fn)

    def close(self):
        for (cls, attr), orig in zip(self.targets, self.origs):
            setattr(cls, attr, orig)

    def summary(self):
        """{kind: (median ms between events, total ms between events, host
        median ms, calls, host clock at the first call's start)}."""
        self.torch.cuda.synchronize()
        out = {}
        for kind in ("load", "upload", "frontend", "fill", "warm", "capture", "replay", "eager"):
            rows = [(s.elapsed_time(e), h * 1e3, t) for k, s, e, h, t in self.calls if k == kind]
            if rows:
                ev = [a for a, _h, _t in rows]
                out[kind] = (float(np.median(ev)), float(sum(ev)),
                             float(np.median([h for _a, h, _t in rows])), len(rows), rows[0][2])
        return out


def stream_phase(torch, dev, counters):
    """cli stream's serving loop on the card in the three STREAM_RUNS runs;
    returns each run's kernel launches (the path's own counts)."""
    from sift_parallel_optimization_tpu_torch import cli
    from sift_parallel_optimization_tpu_torch.models import odometry as odo
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend
    from sift_parallel_optimization_tpu_torch.utils import native
    from sift_parallel_optimization_tpu_torch.utils.profiling import profile_device

    check(native.available(), "stream: the port's host library did not build on the card, so "
          f"no frame can come from it: {native.build_error()}")
    launches, lines = {}, []
    for name, size, window, loops in STREAM_RUNS:
        t_run = time.perf_counter()
        with native.FrameLoader(size, n_buffers=4, n_threads=2, seed=0) as ld:
            ld.next_frame()
            t0 = time.perf_counter()
            for _ in range(STREAM_FRAMES):
                ld.next_frame()
            loader_fps = STREAM_FRAMES / (time.perf_counter() - t0)
        tap = ServeTap(torch, odo, SiftFrontend, cli, native)
        try:
            res, launches[f"stream {name}"] = counted(
                torch, counters, lambda: cli.serve_stream(STREAM_FRAMES, size, 512, 0, window,
                                                          loops, dev))
            t_ret = time.perf_counter()
        finally:
            tap.close()
        got = {k: c for k, c in launches[f"stream {name}"].items() if c}
        check(got == {"patch_gather": STREAM_FRAMES + 1, "score_tables": STREAM_FRAMES + 1},
              f"stream {name}: launched {got}, not kernels 2a and 3 once a frame for "
              f"{STREAM_FRAMES} frames and the warm-up")
        ms = res["seconds"] * 1e3 / STREAM_FRAMES
        times = tap.summary()
        check(set(times) >= {"load", "upload", "frontend"} and times["load"][3] == STREAM_FRAMES + 1,
              f"stream {name}: the loop did not take its frames from the host library's loader")
        host = lambda k: f"{k} {times[k][2]:.3f}" if k in times else f"{k} -"
        ev = lambda k: (f"{k} median {times[k][0]:.3f} ms, total {times[k][1]:.3f} ms "
                        f"(n={times[k][3]})" if k in times else f"{k} none")
        steady_ms, text = ms, ""
        fe, s = res["frontend"], res["stream"]
        if s is not None:
            r = s.runner
            # A capture replays its graph once too.
            n_replay = sum(times.get(k, (0, 0, 0, 0))[3] for k in ("capture", "replay"))
            check(r.replays == n_replay and "replay" in times and len(r.graphs) >= 2
                  and "eager" not in times,
                  f"stream {name}: {r.replays} graph replays for {n_replay} captured or "
                  f"replayed pushes, {len(r.graphs)} graphs")
            # From the first replayed push to the end: the steady rate.
            steady_ms = (t_ret - times["replay"][4]) * 1e3 / times["replay"][3]
        # The device time of a steady served frame: the same loop (load,
        # upload, frontend, push) goes on for STREAM_PROFILED frames on this
        # run's frontend and stream, in one torch.profiler run; every device
        # record of those frames counts, the replayed graphs' kernels with
        # them.
        with native.FrameLoader(size, n_buffers=4, n_threads=2, seed=0) as ld:
            def serve_one():
                feats = fe(cli.upload_frame(ld.next_frame()[1], dev))
                if s is not None:
                    s.push(feats)

            dev_ops, dev_ms, _p = profile_device(serve_one, warmup=1, iters=STREAM_PROFILED)
        if s is not None:
            # The steady step alone is thousands of launches: a trace that
            # kept only the frontend's records has lost the graphs' kernels.
            check(dev_ops > 2000, f"stream {name}: the profiler kept {dev_ops:.0f} device "
                  "records a served frame: the replayed graphs' kernels are missing")
            traj, m, info = s.finish()
            n_pushed = STREAM_FRAMES + 1 + STREAM_PROFILED
            check(traj.rvecs.shape == (n_pushed, 3)
                  and bool(torch.isfinite(traj.rvecs).all() & torch.isfinite(traj.tvecs).all()),
                  f"stream {name}: trajectory {tuple(traj.rvecs.shape)} or non-finite poses")
            extent = np.ptp(traj.tvecs.cpu().numpy(), axis=0).round(3).tolist()
            text = (f"; pushes between events: {ev('fill')}; {ev('warm')}; {ev('capture')}; "
                    f"{ev('replay')}; {s.runner.replays} replays of {len(s.runner.graphs)} "
                    f"graphs; {traj.rvecs.shape[0]} poses ({STREAM_FRAMES} timed, "
                    f"{1 + STREAM_PROFILED} profiled), {len(info['loop_frames'])} loops, "
                    f"{info['loops_dropped']} dropped, extent {extent}")
        syncs = {k: v for k, v in tap.syncs.items() if v}
        lines.append(
            f"({name}) {size}^2 K=512{', dual orientations' if window else ''}"
            f"{f', W={window}' if window else ', frontend only'}"
            f"{', loop closure' if loops else ''}: {STREAM_FRAMES} frames in "
            f"{res['seconds']:.3f} s -> {STREAM_FRAMES / res['seconds']:.1f} fps, {ms:.3f} "
            f"ms/frame end to end, steady {steady_ms:.3f} ms/frame"
            f"{' (from the first replayed push on)' if s is not None else ''}, "
            f"{res['keypoints'] / STREAM_FRAMES:.0f} keypoints/frame; loader alone "
            f"{loader_fps:.1f} frames/s; launches kernel 3 {got['score_tables']}, kernel 2a "
            f"{got['patch_gather']}; host median ms a call: {host('load')}, {host('upload')}, "
            f"{host('frontend')}, {host('replay')}; frontend {times['frontend'][0]:.3f} ms "
            f"median between events" + text
            + f"; a steady served frame on the device (profiled, {STREAM_PROFILED} frames): "
            f"{dev_ms:.3f} ms in {dev_ops:.0f} records: busy {100 * dev_ms / ms:.1f}% of the "
            f"end-to-end frame, {100 * dev_ms / steady_ms:.1f}% of the steady one; host syncs "
            f"in loads, uploads and replayed pushes: 0" + (f"; warn: host syncs {syncs}" if syncs
                                                          else "; no other host sync")
            + f"; run {time.perf_counter() - t_run:.1f} s")
    phase("stream", f"host library {os.path.relpath(native._BUILD_DIR, HERE)} built with"
          f"{'' if native.has_png() else 'out'} libpng; " + "; ".join(lines))
    return launches


def bench_phase(torch, smi, counters):
    """``cli bench`` as a user runs it, its records checked and printed.
    Returns the launches of its runs (captured chains count each launch they
    hold once, as the capture calls the wrapper; replays add nothing)."""
    import math

    from sift_parallel_optimization_tpu_torch import cli

    out_dir = os.path.join(HERE, "build")          # git-ignored, beside the kernels
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "bench_smoke.jsonl")
    if os.path.exists(path):
        os.remove(path)

    def run():
        for workloads, size in BENCH_RUNS:
            argv = ["bench", "--workloads", workloads, "--out", path]
            check(cli.main(argv + (["--size", str(size)] if size else [])) == 0,
                  f"cli bench --workloads {workloads} failed")

    t0 = time.perf_counter()
    _, launches = counted(torch, counters, run)
    seconds = time.perf_counter() - t0
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    check(len(recs) == BENCH_RECORDS, f"bench: {len(recs)} records, not {BENCH_RECORDS}")
    for r in recs:
        check(isinstance(r["value"], (int, float)) and math.isfinite(r["value"])
              and r["value"] > 0, f"bench: {r['metric']} = {r['value']}")
        check(r["device"] == smi and r["backend"] == "cuda",
              f"bench: {r['metric']} names {r['device']!r} / {r['backend']!r}, not {smi!r}")
        if "sol_pct" in r:
            check(r["sol_pct"] is not None and 0 <= r["sol_pct"] <= 100,
                  f"bench: {r['metric']} at {r['sol_pct']}% of its floor {r['floor_ms']} ms: "
                  f"the floor is wrong")
        print(json.dumps(r), flush=True)
    head = next(r for r in recs if r["metric"] == "pyramid_dog_ms_per_frame_512"
                and r["variant"] == "cuda")
    phase("bench", f"{len(recs)} records in {seconds:.1f} s (printed above); headline "
          f"pyramid_dog_ms_per_frame_512 (kernel 1) {head['value']} ms chained, "
          f"{head['sol_pct']}% of {head['floor_ms']} ms, kernel alone {head['device_ms']} "
          f"device ms; " + "; ".join(
              f"{r['metric']}{' ' + r['variant'] if 'variant' in r else ''} {r['value']} "
              f"{r['unit']}" for r in recs if r is not head))
    return launches


def ba_arc(torch, dev, k_np):
    """(start, observations, K) of the BA_FP_CAMS-camera arc on the card:
    BA_FP_PTS points seen by every camera with 0.2 px noise, a perturbed
    start."""
    from sift_parallel_optimization_tpu_torch.models import ba
    from sift_parallel_optimization_tpu_torch.utils import synthetic

    rng = np.random.default_rng(2)
    C, P = BA_FP_CAMS, BA_FP_PTS
    pts = rng.uniform((-2, -1.5, 5), (2, 1.5, 9), (P, 3))
    rv = np.array([[0.0, 0.02 * (i - C / 2), 0.0] for i in range(C)])
    tv = np.array([[0.15 * (i - C / 2), 0.0, 0.0] for i in range(C)])
    kd = k_np.astype(np.float64)

    def project(r, t):
        pc = pts @ synthetic.rodrigues_np(r).T + t
        return ((pc / pc[:, 2:]) @ kd.T)[:, :2]

    uv = np.concatenate([project(rv[i], tv[i]) for i in range(C)])
    uv += rng.normal(size=uv.shape) * 0.2
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    obs = ba.Observations(f32(np.repeat(np.arange(C), P)).int(), f32(np.tile(np.arange(P), C)).int(),
                          f32(uv), torch.ones(C * P, dtype=torch.bool, device=dev))
    start = ba.BAState(f32(rv + 0.005 * rng.normal(size=rv.shape)),
                       f32(tv + 0.02 * rng.normal(size=tv.shape)),
                       f32(pts + 0.03 * rng.normal(size=pts.shape)))
    return start, obs, f32(k_np)


def sfm_cpu_phase(torch, dev):
    """SFM_CPU_FRAMES frames of the sfm scene through run_sfm on the card and
    on the CPU with the same draws (those of the card run, replayed); then
    dense and CG bundle_adjust on one BA_FP_CAMS-camera map on the card."""
    from sift_parallel_optimization_tpu_torch.models import ba, sfm
    from sift_parallel_optimization_tpu_torch.models.frontend import features_from_numpy
    from sift_parallel_optimization_tpu_torch.utils.trajectory import (
        camera_centers,
        umeyama_alignment,
    )

    arrays, _rv, _tv, k_np = sfm_scene(SFM_CPU_FRAMES, seed=1, step=SFM_CPU_STEP)
    draws, gen = {}, torch.Generator(device=dev).manual_seed(1)

    def record(kind, frame, valid, n_hyp, n_pts):
        w = valid.to(torch.float32) + (~valid.any()).to(torch.float32)
        draws[kind, frame] = torch.multinomial(w, n_hyp * n_pts, replacement=True,
                                               generator=gen).view(n_hyp, n_pts)
        return draws[kind, frame]

    def replay(kind, frame, valid, n_hyp, n_pts):
        return draws[kind, frame].to(valid.device)

    runs = {}
    for device, sampler in ((dev, record), ("cpu", replay)):
        feats = [features_from_numpy(a, device=device) for a in arrays]
        K = torch.from_numpy(k_np).to(device)
        m = sfm.run_sfm(None, feats, K, pts_per_frame=SFM_PTS_PER_FRAME, loop_min_gap=2,
                        sampler=sampler)
        runs[str(device)] = (m, float(ba.rms_error(m.ba_state(), m.obs, K)))
    (gm, g_rms), (cm, c_rms) = runs[str(dev)], runs["cpu"]
    gm = type(gm)(*[t.cpu() for t in gm[:-1]], type(gm.obs)(*[t.cpu() for t in gm.obs]))
    check(torch.equal(gm.cam_valid, cm.cam_valid) and bool(cm.cam_valid.all()),
          f"sfm_cpu: cameras {gm.cam_valid.tolist()} (card) vs {cm.cam_valid.tolist()} (CPU)")
    rot_gap = float((gm.rvecs - cm.rvecs).abs().max())
    raw_t_gap = float((gm.tvecs - cm.tvecs).abs().max())
    gc = camera_centers(gm.rvecs, gm.tvecs).double()
    cc = camera_centers(cm.rvecs, cm.tvecs).double()
    scale, R_, t_ = umeyama_alignment(gc, cc)
    align = lambda x: scale * x @ R_.T + t_
    c_gap = float((align(gc) - cc).abs().max())
    check(rot_gap <= SFM_CPU_POSE_ATOL and c_gap <= SFM_CPU_POSE_ATOL,
          f"sfm_cpu: rotations of card and CPU differ by {rot_gap:.2e} rad, aligned camera "
          f"centers by {c_gap:.2e} (scale {float(scale):.6f}; raw translations {raw_t_gap:.2e})")
    valid_diff = float((gm.pt_valid != cm.pt_valid).float().mean())
    obs_diff = float((gm.obs.valid != cm.obs.valid).float().mean())
    check(max(valid_diff, obs_diff) <= 0.01,
          f"sfm_cpu: valid masks differ in {valid_diff:.4f} (points), {obs_diff:.4f} (obs)")
    gp, cp = align(gm.points[gm.pt_valid].double()), cm.points[cm.pt_valid].double()
    check(bool(torch.isfinite(gp).all() and torch.isfinite(cp).all()),
          f"sfm_cpu: non-finite landmarks: {int((~torch.isfinite(gp)).any(1).sum())} (card), "
          f"{int((~torch.isfinite(cp)).any(1).sum())} (CPU)")
    extent = float((cp - cp.mean(0)).abs().max())
    dist = torch.cdist(cp, gp).min(dim=1).values            # finite: checked above
    pt_frac = float((dist <= SFM_CPU_PT_RTOL * extent).double().mean())
    both = gm.pt_valid & cm.pt_valid
    slot_gap = float((align(gm.points[both].double()) - cm.points[both].double()).abs().max())
    check(pt_frac >= SFM_CPU_FRAC,
          f"sfm_cpu: {pt_frac:.4f} of CPU landmarks within {SFM_CPU_PT_RTOL} of the extent "
          f"{extent:.3f} of a card one; nearest distances median {float(dist.median()):.3e}, "
          f"max {float(dist.max()):.3e}; slot by slot {slot_gap:.3e}; {gp.shape[0]} card and "
          f"{cp.shape[0]} CPU landmarks")
    check(abs(g_rms - c_rms) <= 0.01 * c_rms, f"sfm_cpu: RMS {g_rms:.4f} (card) vs {c_rms:.4f}")

    # Dense vs CG on one 20-camera map on the card.
    C, P = BA_FP_CAMS, BA_FP_PTS
    start, obs, K = ba_arc(torch, dev, k_np)
    out = {s: ba.bundle_adjust(start, obs, K, n_iters=20, damping=1e-4, solver=s)
           for s in ("dense", "cg")}
    d, c = out["dense"], out["cg"]
    ba_rot_gap = float((d.rvecs - c.rvecs).abs().max())
    xa = torch.cat([camera_centers(d.rvecs, d.tvecs), d.points]).double()
    xb = torch.cat([camera_centers(c.rvecs, c.tvecs), c.points]).double()
    s_, R, t = umeyama_alignment(xb, xa)
    gap = float((s_ * xb @ R.T + t - xa).abs().max() / (xa - xa.mean(0)).abs().max())
    rms = {s: float(ba.rms_error(o, obs, K)) for s, o in out.items()}
    check(ba_rot_gap <= BA_FP_RTOL and gap <= BA_FP_RTOL,
          f"sfm_cpu: dense and CG BA differ: rotations {ba_rot_gap:.2e}, structure {gap:.2e}")
    check(max(rms.values()) < 0.5, f"sfm_cpu: BA RMS {rms}")
    from sift_parallel_optimization_tpu_torch.utils.profiling import cuda_time_ms

    times = {s: cuda_time_ms(lambda s=s: ba.bundle_adjust(start, obs, K, n_iters=20,
                                                          damping=1e-4, solver=s),
                             warmup=1, iters=3) for s in ("dense", "cg")}
    phase("sfm_cpu", f"run_sfm {SFM_CPU_FRAMES} frames, card vs CPU with the same draws: "
          f"cameras equal, rotations within {rot_gap:.2e} rad, camera centers within "
          f"{c_gap:.2e} after Sim(3) alignment (gate {SFM_CPU_POSE_ATOL}; scale "
          f"{float(scale):.6f}, raw translations within {raw_t_gap:.2e}), "
          f"{pt_frac:.4f} of CPU landmarks within {SFM_CPU_PT_RTOL} of the extent of a card "
          f"one (gate {SFM_CPU_FRAC}), valid masks differ in {valid_diff:.4f} (points) and "
          f"{obs_diff:.4f} (observations) of slots (gate 0.01), RMS {g_rms:.4f} vs {c_rms:.4f} "
          f"px; dense vs CG bundle_adjust on the card: rotations within {ba_rot_gap:.2e}, "
          f"Sim(3)-aligned structure within {gap:.2e} of its extent (gate {BA_FP_RTOL}), RMS "
          f"{rms['dense']:.4f} / {rms['cg']:.4f} px; bundle_adjust {C} cams x {P} pts, 20 "
          f"steps: dense {times['dense']:.3f} ms/call, cg {times['cg']:.3f} ms/call")
    return start, obs, K


def mesh_calls(torch, dev, mesh, img, sift_imgs, batch, keyframes, arc, graph):
    """Every sharded entry point of the distributed layer beside its
    unsharded counterpart on ``mesh``: {name: (sharded call, unsharded
    call, gap of their results, tolerance)}. The REFERENCE splits of
    ``img`` against kernel 1's pyramid (the scale split against the plain
    octave) bitwise; the SIFT pyramid of each of ``sift_imgs`` within
    MESH_SIFT_ATOL; 3-row halo strips exactly; the frontend on ``batch``
    slot for slot; the ring table of ``keyframes`` (descriptors, valid)
    exactly; BA dense and CG on ``arc`` (start, observations, K), 20 steps,
    within MESH_STATE_RTOL of each field's largest magnitude; PGO on
    ``graph`` (poses, edges) within MESH_POSE_ATOL. The mesh phase and
    tools/mesh_multicard.py hold each gap and time both calls."""
    from sift_parallel_optimization_tpu_torch.core.pyramid_ref import (
        SiftPyramid,
        reference_dog_octave,
        reference_dog_pyramid,
    )
    from sift_parallel_optimization_tpu_torch.models import ba
    from sift_parallel_optimization_tpu_torch.models import pose_graph as pg
    from sift_parallel_optimization_tpu_torch.models.frontend import sift_config
    from sift_parallel_optimization_tpu_torch.parallel import ba as pba
    from sift_parallel_optimization_tpu_torch.parallel import frontend as pfe
    from sift_parallel_optimization_tpu_torch.parallel import halo
    from sift_parallel_optimization_tpu_torch.parallel import matching as pm
    from sift_parallel_optimization_tpu_torch.parallel import pose_graph as ppg
    from sift_parallel_optimization_tpu_torch.parallel import scale_space as pss
    from sift_parallel_optimization_tpu_torch.parallel.mesh import (
        all_gather,
        axis_index,
        axis_size,
    )

    full = lambda outs: [o.full_tensor() for o in outs]
    size = img.shape[0]
    calls = {
        "reference rows": (lambda: full(pss.sharded_reference_dog_pyramid(img, 2, mesh)),
                           lambda: reference_dog_pyramid(img, 2), max_err, 0.0),
        "reference octaves": (lambda: full(pss.octave_sharded_reference_dog_pyramid(img, 2, mesh)),
                              lambda: reference_dog_pyramid(img, 2), max_err, 0.0),
        "reference scales (octave 0)": (
            lambda: [pss.scale_sharded_reference_dog_octave(mesh, 2, size)(img).full_tensor()],
            lambda: [reference_dog_octave(img, 2)], max_err, 0.0),
    }
    for im in sift_imgs:
        side = im.shape[0]
        spyr = pss.ShardedSiftPyramid(sift_config(side), side, side, mesh, device=dev)
        upyr = SiftPyramid(sift_config(side), side, device=dev)
        calls[f"SIFT pyramid {side}^2"] = (lambda s=spyr, x=im: full(s(x)),
                                           lambda u=upyr, x=im: u(x), max_err, MESH_SIFT_ATOL)

    n, i = axis_size(mesh, "spatial"), axis_index(mesh, "spatial")
    grid = torch.arange(size * 64, dtype=torch.float32, device=dev).view(size, 64)
    h = size // n
    padded = torch.cat([grid[:1].expand(3, -1), grid, grid[-1:].expand(3, -1)])
    calls["halo 3 rows"] = (
        lambda: [all_gather(halo.exchange_rows(grid[i * h:(i + 1) * h], 3, mesh), mesh, "spatial")],
        lambda: [torch.cat([padded[k * h:k * h + h + 6] for k in range(n)])], max_err, 0.0)

    cfg = sift_config(batch.shape[-1], S=3)

    def slots_gap(got, want):
        return 1.0 - min(compare_frames(torch, frame_of(got, b), frame_of(want, b))[0]
                         for b in range(batch.shape[0]))

    calls[f"frontend {batch.shape[-1]}^2 B={batch.shape[0]}"] = (
        lambda: pfe.gather_features(pfe.batched_extract_features(batch, cfg, 512, mesh=mesh),
                                    mesh),
        lambda: pfe.batched_extract_features(batch, cfg, 512), slots_gap, 0.0)

    desc, val = keyframes
    calls[f"ring table {desc.shape[0]}x{desc.shape[1]}"] = (
        lambda: [pm.ring_pairwise_match_counts(mesh, desc, val)],
        lambda: [pm.pairwise_match_counts(desc, val)], max_err, 0.0)

    start, obs, k_arc = arc

    def state_gap(a, b):
        return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

    for solver in ("dense", "cg"):
        kw = dict(n_iters=20, damping=1e-4, solver=solver)
        calls[f"BA {solver} 20 steps"] = (
            lambda kw=kw: pba.distributed_bundle_adjust(start, obs, k_arc, mesh, **kw),
            lambda kw=kw: ba.bundle_adjust(start, obs, k_arc, **kw), state_gap,
            MESH_STATE_RTOL)

    poses, edges = graph
    kw = dict(n_iters=MESH_PGO_ITERS, damping=1e-4)
    calls[f"PGO {poses.rvecs.shape[0]} nodes {MESH_PGO_ITERS} steps"] = (
        lambda: ppg.distributed_pgo(poses, edges, mesh, **kw),
        lambda: pg.optimize_pose_graph(poses, edges, solver="dense", **kw), max_err,
        MESH_POSE_ATOL)
    return calls


def pgo_graph(torch, dev):
    """The pgo phase's PGO_NODES-node SE(3) graph: (drifted poses, edges)."""
    from sift_parallel_optimization_tpu_torch.models import pose_graph as pg

    _gt, (er, et), edges = pose_graph_scene(PGO_NODES, PGO_NODES // 2, PGO_LOOP_EVERY,
                                            noise=PGO_NOISE)
    return (pg.Poses(torch.from_numpy(er).to(dev), torch.from_numpy(et).to(dev)),
            pg.pose_graph_edges_from_numpy(
                {f: edges[f] for f in ("i", "j", "rel_rvec", "rel_tvec", "weight")}, dev))


def mesh_phase(torch, dev, counters, frames, batched, sfm_out, arc):
    """The distributed layer at world size 1 under NCCL (see
    MESH_SIFT_ATOL); returns the launches of its two counted paths, the
    mesh frontend and the dry run."""
    import torch.distributed as dist

    from sift_parallel_optimization_tpu_torch.models import loop_closure
    from sift_parallel_optimization_tpu_torch.models.frontend import sift_config
    from sift_parallel_optimization_tpu_torch.models.geometry import Camera
    from sift_parallel_optimization_tpu_torch.ops import scale_space as ss
    from sift_parallel_optimization_tpu_torch.parallel import frontend as pfe
    from sift_parallel_optimization_tpu_torch.parallel.dryrun import dryrun_multichip
    from sift_parallel_optimization_tpu_torch.parallel.mesh import (
        all_gather,
        all_reduce,
        initialize_distributed,
        make_mesh,
    )
    from sift_parallel_optimization_tpu_torch.utils.profiling import cuda_time_ms

    t0 = time.perf_counter()
    check(not dist.is_initialized(), "mesh: a process group exists before the phase")
    initialize_distributed(device=dev)
    try:
        world, backend = dist.get_world_size(), dist.get_backend()
        check(world == 1 and backend == "nccl", f"mesh: world {world} under {backend}")
        mesh = make_mesh(1, 1)
        batch = torch.stack(frames[512])
        cfg = sift_config(512, S=3)
        out, launches = counted(torch, counters, lambda: pfe.gather_features(
            pfe.batched_extract_features(batch, cfg, 512, mesh=mesh), mesh))
        fracs = [compare_frames(torch, frame_of(out, i), frame_of(batched, i))
                 for i in range(BATCH)]
        check(min(f[0] for f in fracs) >= BATCH_SLOT_FRAC and min(f[1] for f in fracs)
              >= DESC_FRAC, f"mesh: frontend differs from the batched phase's: {fracs}")

        m, feats, _K = sfm_out
        keyframes = (torch.stack([f.descriptors for f in feats]),
                     torch.stack([f.keypoints.valid for f in feats]))
        calls = mesh_calls(torch, dev, mesh, frames["headline"],
                           [frames[512][0], frames[1024][0]], batch, keyframes, arc,
                           pgo_graph(torch, dev))
        n, B = SFM_FRAMES, SFM_PTS_PER_FRAME
        blocks = m.obs.valid[3 * n * B:].view(-1, B)
        loop_frames = [int(m.obs.cam_idx[3 * n * B + b * B]) for b in range(blocks.shape[0])
                       if bool(blocks[b].any())]
        check(len(loop_frames) >= 1, "mesh: the sfm map holds no loop")
        cams = [Camera(m.rvecs[f], m.tvecs[f]) for f in loop_frames]
        map_fields = lambda c: (c.rvecs, c.tvecs, c.points)
        calls[f"close_loops {n} frames, {len(loop_frames)} loops"] = (
            lambda: map_fields(loop_closure.close_loops(m, n, loop_frames, cams, B, mesh=mesh)),
            lambda: map_fields(loop_closure.close_loops(m, n, loop_frames, cams, B)), max_err,
            MESH_POSE_ATOL)
        gaps = {}
        for name, (sharded, unsharded, gap, tol) in calls.items():
            gaps[name] = gap(sharded(), unsharded())
            check(gaps[name] <= tol, f"mesh: {name}: gap {gaps[name]:.3e} above {tol}")

        # The dry run's data-parallel step runs kernel 1 on two 64^2 frames
        # with 3 octaves: held to the plain version at that shape first.
        img64 = torch.from_numpy(np.random.default_rng(0).random((64, 64), np.float32)).to(dev)
        check(all(same_bits(torch, a, b) for a, b in zip(
            ss.reference_dog_pyramid_cuda(img64, 2, 3), ss.reference_dog_pyramid_plain(img64, 2, 3))),
            "mesh: kernel 1 at 64^2, 3 octaves, not bitwise equal to plain")
        held("reference_dog_pyramid", img64, 2, 3)
        dry, dry_launches = counted(torch, counters, lambda: dryrun_multichip(1, device=dev))
        check(dry_launches["reference_dog_pyramid"] == 2,
              f"mesh: the dry run launched {dry_launches}, not kernel 1 once a frame")
        check(all(np.isfinite(v).all() for k, v in dry.items() if k != "mesh"),
              f"mesh: dryrun {dry}")
        checked_s = time.perf_counter() - t0
        # What one degenerate collective costs a call, beside a copy.
        one = torch.ones(1, device=dev)
        timed = {name: (a, b) for name, (a, b, _gap, _tol) in calls.items()}
        timed["all_reduce of one float"] = (lambda: all_reduce(one, mesh, "data"), one.clone)
        timed["all_gather of one float"] = (lambda: all_gather(one, mesh, "data"), one.clone)
        times = {name: (cuda_time_ms(a, warmup=1, iters=3), cuda_time_ms(b, warmup=1, iters=3))
                 for name, (a, b) in timed.items()}
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "mesh: the group outlived the phase")
    phase("mesh", f"world sizes run: 1 (torch.cuda.device_count() = "
          f"{torch.cuda.device_count()}: NCCL takes one card a rank), backend nccl, mesh 1x1; "
          f"frontend {512}^2 B={BATCH} vs the batched phase: slots equal "
          f"{min(f[0] for f in fracs):.4f}, descriptors {min(f[1] for f in fracs):.4f}, "
          f"launches {launches}; gaps to the unsharded results (tolerance): " + "; ".join(
              f"{k} {g:.2e} ({calls[k][3]})" for k, g in gaps.items())
          + f"; dryrun {dry['mesh']} finite, launches {dry_launches}; checks "
          f"{checked_s:.1f} s; per call ms, "
          f"sharded / unsharded: " + "; ".join(f"{k} {a:.3f} / {b:.3f}"
                                               for k, (a, b) in times.items()))
    return {"mesh": launches, "mesh dryrun": dry_launches}


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from sift_parallel_optimization_tpu_torch.bench import roofline as R
        from sift_parallel_optimization_tpu_torch.config import num_octaves
        from sift_parallel_optimization_tpu_torch.core import pyramid_ref
        from sift_parallel_optimization_tpu_torch.models import descriptor
        from sift_parallel_optimization_tpu_torch.models.frontend import (
            SiftFrontend,
            sift_config,
        )
        from sift_parallel_optimization_tpu_torch.ops import _build
        from sift_parallel_optimization_tpu_torch.ops import gather_resample as gr
        from sift_parallel_optimization_tpu_torch.ops import patch_gather as pg
        from sift_parallel_optimization_tpu_torch.ops import scale_space as ss
        from sift_parallel_optimization_tpu_torch.ops import score_tables as st
        from sift_parallel_optimization_tpu_torch.utils import native
        from sift_parallel_optimization_tpu_torch.utils.profiling import (
            cuda_time_ms,
            device_kernel_ms,
        )
    except ImportError as e:
        print(f"FAIL: the port is not importable from {HERE}: {e}", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    peaks = R.device_peaks(dev)

    # 1. Device.
    phase("device", f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} nvidia-smi='{smi}' "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. Build every kernel from the checkout's sources.
    t0 = time.perf_counter()
    nvcc_s = _build.build(force=True)
    _build.load_kernels()
    record_shapes()
    phase("build", f"nvcc {nvcc_s:.2f} s, build+load {time.perf_counter() - t0:.2f} s "
          f"-> {os.path.relpath(_build.LIB_PATH, HERE)}")

    # 3. Kernel 1 vs its plain version on the card.
    k1_err, k1_imgs = kernel1_checks(torch, ss, dev)
    img512 = torch.from_numpy(native.synth_frame(512, 0, seed=0)).to(dev)
    k1_imgs[512] = img512
    # Device time of the launched kernels (profiler), and per-call time
    # between CUDA events, which includes the host's enqueue time. The floor
    # of any launch: the cheapest device operation the port has, timed the
    # same way.
    k1_times = {n: (device_kernel_ms(ss.reference_dog_pyramid_cuda, img, 2, iters=30),
                    device_kernel_ms(ss.reference_dog_pyramid_plain, img, 2, iters=10))
                for n, img in sorted(k1_imgs.items())}
    k1_ms, k1_plain_ms = k1_times[512]
    k1_call = cuda_time_ms(ss.reference_dog_pyramid_cuda, img512, 2, iters=50)
    k1_plain_call = cuda_time_ms(ss.reference_dog_pyramid_plain, img512, 2, iters=50)
    launch_floor_ms = device_kernel_ms(torch.zeros(1, device=dev).zero_, iters=50)
    del k1_imgs[4096]
    phase("kernel1", f"reference_dog_pyramid S=2, all octaves, bitwise equal to plain at "
          f"{'/'.join(map(str, K1_SIZES))}^2: max_abs_err={k1_err:.3e}; device: " + "; ".join(
              f"{n}^2 kernel {m:.4f} ms, plain {p:.4f} ms" for n, (m, p) in k1_times.items())
          + f"; a one-element zero_() {launch_floor_ms:.4f} ms; 512^2 per call: kernel "
          f"{k1_call:.4f} ms, plain {k1_plain_call:.4f} ms")

    # 4. Kernel 2 vs its plain version on the card, on the frontend's atlases
    # (256^2: the stream's README run).
    rng = np.random.default_rng(0)
    rows, cols = 96, 256
    k2_ms, k2_err, k2_lib = {}, 0.0, {}
    for size, k in K2_CONFIGS:
        atlas = frontend_atlas(torch, dev, size, 3)
        ys, xs = gather_origins(torch, rng, k, atlas.shape[0], atlas.shape[1], rows, cols, dev)
        k2_lib[size, k] = device_kernel_ms(
            gather_index_call(torch, atlas, ys, xs, rows, cols), iters=50)
        got = pg.extract_atlas_patches_cuda(atlas, ys, xs, rows, cols)
        want = pg.extract_atlas_patches_plain(atlas, ys, xs, rows, cols)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"kernel 2 not bitwise equal at {size}^2, K={k}")
        held("patch_gather", atlas, ys, xs, rows, cols)
        k2_err = max(k2_err, float((got - want).abs().max()))
        args = (atlas, ys, xs, rows, cols)
        k2_ms[size, k] = (
            device_kernel_ms(pg.extract_atlas_patches_cuda, *args, iters=50),
            device_kernel_ms(pg.extract_atlas_patches_plain, *args, iters=50),
            cuda_time_ms(pg.extract_atlas_patches_cuda, *args, iters=50),
            cuda_time_ms(pg.extract_atlas_patches_plain, *args, iters=50),
            tuple(atlas.shape),
            R.patch_footprint_bytes(atlas.shape, ys, xs, rows, cols),
            flushed_kernel_ms(torch, pg.extract_atlas_patches_cuda, *args),
        )
    phase("kernel2", "patch_gather 96x256 bitwise equal; " + "; ".join(
        f"{size}^2 K={k} atlas {a}: device kernel {m:.4f} ms (L2 flushed before each call "
        f"{fl:.4f}), plain {p:.4f} ms, one indexing call {k2_lib[size, k]:.4f} ms; per call "
        f"kernel {mc:.4f} ms, plain {pc:.4f} ms; windows cover {foot / 2**20:.2f} of "
        f"{4 * np.prod(a) / 2**20:.2f} atlas MiB"
        for (size, k), (m, p, mc, pc, a, foot, fl) in k2_ms.items()))

    # 4a. The batched gather vs its plain version on the card, on the batched
    # frontend's own (B, R, C) atlases, plus one atlas shared by all frames
    # (256^2 at K=256: the odometry phase's batched frontend).
    k2b_ms, k2b_err, k2b_cases = {}, 0.0, 0
    for size, k in K2B_CONFIGS:
        fe = SiftFrontend(sift_config(size, S=3), device=dev)
        batch = torch.stack([torch.from_numpy(native.synth_frame(size, i, seed=0))
                             for i in range(BATCH)]).to(dev)
        atlases, _meta = descriptor.build_atlas(fe.pyramid(batch))
        check(atlases.dim() == 3 and atlases.shape[0] == BATCH, "kernel 2b: atlas shape")
        ys, xs = batched_gather_origins(torch, rng, BATCH, k, atlases.shape[1],
                                        atlases.shape[2], rows, cols, dev)
        for name, atlas in (("batched", atlases), ("shared", atlases[0].contiguous())):
            got = pg.extract_atlas_patches_batched_cuda(atlas, ys, xs, rows, cols)
            want = pg.extract_atlas_patches_batched_plain(atlas, ys, xs, rows, cols)
            torch.cuda.synchronize()
            check(got.shape == (BATCH, k, rows, cols) and torch.equal(got, want),
                  f"kernel 2b ({name} atlas) not bitwise equal at {size}^2, B={BATCH}, K={k}")
            held("patch_gather_batched", atlas, ys, xs, rows, cols)
            k2b_err = max(k2b_err, float((got - want).abs().max()))
            k2b_cases += 1
            del got, want
        args = (atlases, ys, xs, rows, cols)
        k2b_ms[size] = (
            device_kernel_ms(pg.extract_atlas_patches_batched_cuda, *args, iters=20),
            device_kernel_ms(pg.extract_atlas_patches_batched_plain, *args, iters=20),
            cuda_time_ms(pg.extract_atlas_patches_batched_cuda, *args, iters=20),
            cuda_time_ms(pg.extract_atlas_patches_batched_plain, *args, iters=20),
            device_kernel_ms(gather_index_call(torch, *args), iters=20),
            tuple(atlases.shape), k,
            R.patch_footprint_bytes(atlases.shape, ys, xs, rows, cols),
            flushed_kernel_ms(torch, pg.extract_atlas_patches_batched_cuda, *args),
        )
        del atlases, batch
    phase("kernel2b", f"patch_gather_batched 96x256, B={BATCH}, bitwise equal in {k2b_cases} "
          f"cases (per-frame and shared atlas; last legal origin of the last frame, negative "
          f"and over-range origins in a middle frame); " + "; ".join(
              f"{size}^2 K={k} atlases {a}: device kernel {m:.4f} ms (L2 flushed before each "
              f"call {fl:.4f}), plain {p:.4f} ms, one indexing call {lib:.4f} ms; per call "
              f"kernel {mc:.4f} ms, plain {pc:.4f} ms; windows cover {foot / 2**20:.2f} of "
              f"{4 * np.prod(a) / 2**20:.2f} atlas MiB"
              for size, (m, p, mc, pc, lib, a, k, foot, fl) in k2b_ms.items()))

    # 4b. Kernel 3, both entry points, vs the plain versions on the card; the
    # block top-2 tables timed in the two forms the paths launch: one frame
    # (the per-frame frontend) and BATCH frames (the batched frontend).
    t_k3 = time.perf_counter()
    k3_cases, k3_err, stacks, k3_flats = kernel3_checks(torch, st, dev)
    t_k3 = [time.perf_counter() - t_k3, time.perf_counter()]
    k3_ms = {}
    for name in ("random 512x512", "random 1024x1024"):
        dog = stacks[name][0][0]
        k3_ms[f"rows {name}"] = tuple(
            f(g, dog, THR, EDGE_RATIO, iters=50)
            for f in (device_kernel_ms, cuda_time_ms)
            for g in (st.score_tables_rows_cuda, st.score_tables_rows_plain))
    for size, b in K3_TIMED:
        flat, shapes = k3_flats[size]
        args = (flat[:b], shapes, THR, EDGE_RATIO, 1)
        # The plain version launches thousands of ops a call (a batch of 8:
        # ~200 ms of host time), and the profiler takes seconds to read a run
        # of them: it is timed over fewer calls than the kernel.
        kernel, plain = dict(iters=20 if b == 1 else 5), dict(warmup=1, iters=5 if b == 1 else 2)
        k3_ms[f"block_top2 {size}^2 pyramid B={b}"] = tuple(
            f(g, *args, **kw)
            for f in (device_kernel_ms, cuda_time_ms)
            for g, kw in ((st.score_block_top2_cuda, kernel), (st.score_block_top2_plain, plain)))
    t_k3[1] = time.perf_counter() - t_k3[1]
    phase("kernel3", f"score_tables rows + block_top2 bitwise equal to plain in {k3_cases} "
          f"cases (checks {t_k3[0]:.0f} s, timing {t_k3[1]:.0f} s), max_abs_err={k3_err:.3e} "
          f"(random 512^2, 1024^2, 250x370 stacks and frontend "
          f"{', '.join(f'{n}^2' for n in K3_FRONTEND)} octaves, one frame a launch; the "
          f"{BATCH} frames of each frontend stream in one launch; "
          f"{', '.join(K3_EXTRA)}); " +
          "; ".join(f"{n}: device kernel {m:.4f} ms, plain {p:.4f} ms; per call kernel "
                    f"{mc:.4f} ms, plain {pc:.4f} ms" for n, (m, p, mc, pc) in k3_ms.items()))

    # 4c. Kernel 4 vs its plain version on the card, on the frontend's atlases.
    k4_ms, k4_err, k4_touched = {}, 0.0, {}
    for size, k in ((512, 512), (1024, 2048)):
        args = kernel4_inputs(torch, rng, k, frontend_atlas(torch, dev, size, 3), dev)
        k4_touched[k] = R.resample_footprint_bytes(args[3], args[0].numel())
        got = gr.gather_resample_cuda(*args)
        want = gr.gather_resample_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(bool(torch.allclose(g, w, rtol=K4_RTOL, atol=K4_ATOL)),
                  f"kernel 4 disagrees with plain at K={k}: {max_err(got, want)}")
        held("gather_resample", *args)
        k4_err = max(k4_err, max_err(got, want))
        k4_ms[k] = (
            device_kernel_ms(gr.gather_resample_cuda, *args, iters=50),
            device_kernel_ms(gr.gather_resample_plain, *args, iters=50),
            cuda_time_ms(gr.gather_resample_cuda, *args, iters=50),
            cuda_time_ms(gr.gather_resample_plain, *args, iters=50),
            tuple(args[0].shape),
        )
    phase("kernel4", f"gather_resample 18^2 + 26^2 grids: max_abs_err={k4_err:.3e} (rtol "
          f"{K4_RTOL}, atol {K4_ATOL}); " + "; ".join(
              f"K={k} atlas {a}: device kernel {m:.4f} ms, plain {p:.4f} ms; per call kernel "
              f"{mc:.4f} ms, plain {pc:.4f} ms" for k, (m, p, mc, pc, a) in k4_ms.items()))

    # Inputs of the main path, on the card before the run.
    frames = {"headline": img512}
    for size, _S, _k in FRONTEND_CONFIGS:
        frames[size] = [
            torch.from_numpy(native.synth_frame(size, i, seed=0)).to(dev) for i in range(BATCH)
        ]
    # Counters from the main path's runs alone, one path at a time.
    counters = {"reference_dog_pyramid": (ss, "LAUNCHES"), "patch_gather": (pg, "LAUNCHES"),
                "patch_gather_batched": (pg, "LAUNCHES_BATCHED"),
                "score_tables": (st, "LAUNCHES"), "gather_resample": (gr, "LAUNCHES")}
    pyr, feats, path_launches = drive_main_path(torch, dev, frames, counters)

    # 5. Headline: the kernel path vs the plain version on CPU tensors.
    want = pyramid_ref.reference_dog_pyramid(img512.cpu(), 2)
    check(len(pyr) == len(want), "headline: octave count")
    for g, w in zip(pyr, want):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()), "headline: shape/finite")
        check(bool(torch.allclose(g.cpu(), w, rtol=0, atol=HEADLINE_ATOL)),
              f"headline disagrees with the CPU plain run: {max_err([g.cpu()], [w])}")
    head_err = max(float((g.cpu() - w).abs().max()) for g, w in zip(pyr, want))
    head_ms = cuda_time_ms(pyramid_ref.reference_dog_pyramid, img512, 2, iters=50)
    head_plain_ms = cuda_time_ms(ss.reference_dog_pyramid_plain, img512, 2, iters=50)
    head_dev = device_kernel_ms(pyramid_ref.reference_dog_pyramid, img512, 2, iters=50)
    phase("headline", f"pyramid+DoG 512^2 S=2 synth_frame: {len(pyr)} octaves, vs CPU plain "
          f"max_abs_err={head_err:.3e} (atol {HEADLINE_ATOL}); kernel path {head_ms:.4f} "
          f"ms/frame (device {head_dev:.4f} ms), plain torch on card {head_plain_ms:.4f} ms/frame")

    # 6. Frontend at both configs (block-reduce detection, the card's
    # default) and with fused sampling: sanity on every frame, parity of
    # frame 0 with the same branches run on CPU tensors.
    timings = {}
    for name, (size, S, k) in [(c[0], c) for c in FRONTEND_CONFIGS] + [("fused", FUSED_CONFIG)]:
        fe, out = feats[name]
        check_features(torch, out, size, k)
        cpu_fe = SiftFrontend(sift_config(size, S=S), max_keypoints=k, device="cpu",
                              use_approx_topk=True)
        descriptor.USE_FUSED_SAMPLING = name == "fused"
        try:
            cpu = cpu_fe(frames[size][0].cpu())
            frac, dfrac, n_cpu, n_gpu = compare_with_cpu(torch, out[0], cpu, size)
            check(frac >= MATCH_FRAC, f"frontend {name}: only {frac:.4f} of CPU keypoints matched")
            check(dfrac >= DESC_FRAC, f"frontend {name}: only {dfrac:.4f} of descriptors within L2")
            timings[name] = (frame_ms(torch, fe, frames[size][:FRAMES])
                             + device_profile(torch, fe, frames[size][0]))
        finally:
            descriptor.USE_FUSED_SAMPLING = False
        ms, mx, n, nk, dms = timings[name]
        check(round(nk) <= FRAME_OPS_MAX, f"frontend {name}: {nk:.0f} device ops a frame, more than "
              f"{FRAME_OPS_MAX}")
        counts = [int(o.keypoints.count()) for o in out]
        phase("frontend", f"{name if name == 'fused' else 'block-reduce'} {size}^2 S={S} K={k}: "
              f"median {ms:.3f} ms/frame, max {mx:.3f} (n={n}, host clock, synchronized), "
              f"device {dms:.3f} ms in {nk:.0f} device ops/frame; keypoints/frame "
              f"{min(counts)}..{max(counts)}; frame 0 vs CPU: {n_gpu} vs {n_cpu} keypoints, "
              f"matched {frac:.4f}, descriptors within L2 {DESC_L2}: {dfrac:.4f}")

    # 7. The exact branch on the card: recall of the block-reduce branch
    # against it on frame 0, and its frame time in this same call.
    for size, S, k in FRONTEND_CONFIGS:
        exact = SiftFrontend(sift_config(size, S=S), max_keypoints=k, device=dev,
                             use_approx_topk=False)
        want = keyset(exact(frames[size][0]).keypoints)
        got = keyset(feats[size][1][0].keypoints)
        check(len(want) > 0, f"exact branch {size}: no keypoints")
        recall = len(want & got) / len(want)
        check(recall >= RECALL_MIN, f"block-reduce recall {recall:.4f} at {size}")
        ms, mx, n, nk, dms = frame_ms(torch, exact, frames[size][:FRAMES]) + device_profile(
            torch, exact, frames[size][0])
        bms, _bmx, _bn, bnk, bdms = timings[size]
        phase("recall", f"{size}^2 K={k}: block-reduce found {recall:.4f} of the exact branch's "
              f"{len(want)} keypoints (gate {RECALL_MIN}); exact branch median {ms:.3f} "
              f"ms/frame, max {mx:.3f} (n={n}), device {dms:.3f} ms in {nk:.0f} ops/frame; "
              f"block-reduce {bms:.3f} ms/frame, device {bdms:.3f} ms in {bnk:.0f} ops/frame")

    # 7b. The batched frontend: every frame against the per-frame frontend
    # on the card, and its time per frame beside the per-frame one's.
    for size, S, k in FRONTEND_CONFIGS:
        fe, out = feats[f"batched {size}"]
        check(out.descriptors.shape == (BATCH, k, 128), f"batched {size}: shapes")
        check_features(torch, [frame_of(out, i) for i in range(BATCH)], size, k)
        per_frame = feats[size][1] + [fe(f) for f in frames[size][FRAMES:]]
        fracs = [compare_frames(torch, frame_of(out, i), per_frame[i]) for i in range(BATCH)]
        slot_frac, desc_frac = min(f[0] for f in fracs), min(f[1] for f in fracs)
        check(slot_frac >= BATCH_SLOT_FRAC,
              f"batched {size}: only {slot_frac:.4f} of a frame's slots equal the per-frame run")
        check(desc_frac >= DESC_FRAC,
              f"batched {size}: only {desc_frac:.4f} of a frame's descriptors within L2")
        batch = torch.stack(frames[size])
        bms, bmx, bn, bnk, bdms = frame_ms(torch, fe, [batch], passes=6) + device_profile(
            torch, fe, batch, iters=3)
        ms, mx, n, nk, dms = timings[size]
        check(round(bnk) <= BATCH_OPS_MAX, f"batched {size}: {bnk:.0f} device ops a batch, more than "
              f"{BATCH_OPS_MAX}")
        counts = [int(c) for c in out.keypoints.count()]
        phase("batched", f"{size}^2 S={S} K={k} B={BATCH}: every frame vs the per-frame "
              f"frontend on the card: slots equal {slot_frac:.4f} (min over frames, gate "
              f"{BATCH_SLOT_FRAC}), descriptors within L2 {DESC_L2}: {desc_frac:.4f}; "
              f"keypoints/frame {min(counts)}..{max(counts)}; batched median "
              f"{bms / BATCH:.3f} ms/frame, max {bmx / BATCH:.3f} (n={bn} batches, host clock, "
              f"synchronized), device {bdms / BATCH:.3f} ms and {bnk / BATCH:.1f} device "
              f"ops/frame ({bnk:.0f} per batch); per-frame {ms:.3f} ms/frame, max {mx:.3f} "
              f"(n={n}), device {dms:.3f} ms in {nk:.0f} ops/frame")
        del batch

    # 7c. A matched, verified pair and the two-view bootstrap.
    pair_phase(torch, dev, feats["batched 512"][1])
    twoview_phase(torch, dev)

    # 7d. The tracking step: windowed odometry with loop closure on rendered
    # frames through the batched frontend (its frontend's launches counted as
    # the path's own), and the pose-graph solvers it ends with.
    path_launches["odometry"], odo_feats, odo_K, fifo = odometry_phase(torch, dev, counters)
    stream_equiv_phase(torch, dev, odo_feats, odo_K, fifo)
    del odo_feats
    pgo_phase(torch, dev)

    # 7d'. Online serving: cli stream's loop on the card, frontend only and
    # with online odometry (each run's frontend launches counted as its own).
    path_launches.update(stream_phase(torch, dev, counters))

    # 7e. Incremental SfM with loop closure at configuration 4, and the same
    # driver on the card against the CPU.
    sfm_out = sfm_phase(torch, dev)
    arc = sfm_cpu_phase(torch, dev)

    # 7e'. The distributed layer on a world-size-1 NCCL mesh, the launches of
    # its frontend and of its dry run counted as paths of their own.
    path_launches.update(mesh_phase(torch, dev, counters, frames,
                                    feats[f"batched {FRONTEND_CONFIGS[0][0]}"][1], sfm_out, arc))
    del sfm_out, arc

    # 7f. The benchmark matrix through cli bench, its launches counted as
    # its own.
    path_launches["bench"] = bench_phase(torch, smi, counters)

    # 8. Each path of the main path went through its kernels; the batched
    # frontend launches each of its kernels ONCE for the whole batch.
    for path, kernels in PATH_KERNELS.items():
        for name in kernels:
            check(path_launches[path][name] > 0,
                  f"{name} was not launched by the main path's {path} run")
        if str(path).startswith("batched") or path == "mesh":
            got = {n: c for n, c in path_launches[path].items() if c}
            check(got == {"patch_gather_batched": 1, "score_tables": 1},
                  f"the {path} run launched {got}, not one launch of each kernel per batch")
        label = f"frontend {path}^2" if isinstance(path, int) else path
        phase("launches", f"{label}: " + ", ".join(
            f"{name} {n}" for name, n in path_launches[path].items()))
    launches = {name: sum(c[name] for c in path_launches.values()) for name in counters}

    # 9. Every shape a kernel launched at in this run was one a check held it
    # to its plain version at.
    for name in sorted(LAUNCHED):
        missing = LAUNCHED[name] - HELD.get(name, set())
        check(not missing, f"{name} launched at shapes no check held it at: {sorted(missing)}")
    phase("shapes", "every launch at a shape held to the plain version: " + "; ".join(
        f"{name} {len(LAUNCHED[name])} shapes" for name in sorted(LAUNCHED)))

    # Bounds from this run's inputs (bench/roofline.py's kernel models: each
    # input read once, each output written once) against the card's
    # published peaks; for every shape timed above.
    def bound(model):
        return model.kernel_bound(peaks)

    check(sum(o.numel() for o in pyr) == sum(
        5 * (512 >> o) ** 2 for o in range(num_octaves(512))), "bounds: pyramid size at 512")
    k1_bound = bound(R.reference_dog_kernel_model(512, 2))

    def gather_bound(n_patches, atlas_shape, footprint):
        return bound(R.patch_gather_model(n_patches, rows, cols, int(np.prod(atlas_shape)),
                                          footprint))

    def tables_bound(size, b):
        return bound(R.score_tables_model(k3_flats[size][1], b))

    def rows_bound(dog):
        return bound(R.score_rows_model(*dog.shape))

    def resample_bound(k):
        return bound(R.gather_resample_model(k, k4_touched[k]))

    bounds = {
        **{f"reference_dog_pyramid {n}^2 S=2": bound(R.reference_dog_kernel_model(n, 2))
           for n in K1_TIMED},
        **{f"patch_gather {size}^2 K={k}": gather_bound(k, *k2_ms[size, k][4:6])
           for size, k in K2_CONFIGS},
        **{f"patch_gather_batched {size}^2 B={BATCH} K={k}": gather_bound(
            BATCH * k, k2b_ms[size][5], k2b_ms[size][7])
           for size, k in K2B_CONFIGS},
        **{f"score_tables block_top2 {size}^2 B={b}": tables_bound(size, b)
           for size, b in K3_TIMED},
        "score_tables rows (5,512,512)": rows_bound(stacks["random 512x512"][0][0]),
        "score_tables rows (5,1024,1024)": rows_bound(stacks["random 1024x1024"][0][0]),
        "gather_resample K=512": resample_bound(512),
        "gather_resample K=2048": resample_bound(2048),
    }
    phase("bounds", f"least ms at {peaks.hbm_gbps / 1e3:.2f} TB/s and "
          f"{peaks.elementwise_tflops:.0f} fp32 TFLOP/s ({peaks.name}): " + "; ".join(
              f"{name}: {ms:.4f} ({by})" for name, (ms, by) in bounds.items())
          + f"; floor of any launch (a one-element zero_()): {launch_floor_ms:.4f} ms")
    k2_bound, k2b_bound = bounds["patch_gather 512^2 K=512"], bounds[
        f"patch_gather_batched 512^2 B={BATCH} K=512"]
    k3_bound = bounds["score_tables block_top2 512^2 B=1"]
    k4_bound = bounds["gather_resample K=512"]
    m512, p512 = k2_ms[512, 512][:2]
    mb, pb, _mc, _pc, libb = k2b_ms[512][:5]
    m3, p3 = k3_ms["block_top2 512^2 pyramid B=1"][:2]
    m4, p4 = k4_ms[512][:2]

    def entry(name, source, replaces, err, ms, plain, bound, library):
        # No kernel can beat the least time its work needs: a share above
        # 100% means the bound charges bytes the kernel does not move.
        check(bound[0] <= ms, f"{name}: {ms:.4f} ms is under its bound {bound[0]:.4f} ms")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library}

    print(json.dumps({"kernels": [
        entry("reference_dog_pyramid", SRC_K1, REPLACES_K1, k1_err, k1_ms, k1_plain_ms,
              k1_bound, None),
        entry("patch_gather", SRC_K2, REPLACES_K2, k2_err, m512, p512, k2_bound, k2_lib[512, 512]),
        entry("patch_gather_batched", SRC_K2, REPLACES_K2B, k2b_err, mb, pb, k2b_bound, libb),
        entry("score_tables", SRC_K3, REPLACES_K3, k3_err, m3, p3, k3_bound, None),
        entry("gather_resample", SRC_K4, REPLACES_K4, k4_err, m4, p4, k4_bound, None),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
