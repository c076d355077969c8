"""Analytic roofline for the bench records and the kernel bounds (port of
``bench/roofline.py``).

Every workload of ``bench/suite.py`` gets an analytic cost (algorithmic
flops, minimal HBM traffic, gathered elements) against one table of device
peaks, so a record can carry

    sol_pct = 100 * floor_ms / measured_ms

Conventions (the JAX module's, except where marked):

* Flops are ALGORITHMIC (a blur counts 2*(2r+1) flops per output pixel:
  the taps the math needs), not what the port's dense Toeplitz products
  issue. %SOL measures distance from the problem's floor, not from the
  port's own schedule.
* HBM bytes are the MINIMAL traffic of a perfectly fused schedule: each
  input read once, each live output written once.
* Copies count read plus write. The H100's HBM rate is one figure for
  both directions; the JAX module charged copies one way, a calibration of
  the TPU's DMA engines (see :func:`descriptor_model`).
* The floor is max(memory, matmul, elementwise, gather): perfect overlap,
  a true speed of light.

Peaks are NVIDIA's published figures for the attached part, looked up by
``torch.cuda.get_device_name`` (:func:`device_peaks`); an unknown part
raises, and a CPU run has no peaks (floors and shares are None there, never
computed against another device's peaks). The one entry: the H100 SXM5
80 GB ("NVIDIA H100 80GB HBM3", 700 W power limit), from NVIDIA's H100
Tensor Core GPU datasheet, dense rates: HBM3 3.35 TB/s; FP32 67 TFLOP/s
outside the tensor cores; NVLink 4 900 GB/s a GPU, 450 GB/s each way. Both
matmul classes are charged at the fp32 rate: the port pins fp32 matmuls
(``core/pyramid_ref.check_fp32_matmul``), so the products the JAX package
runs at DEFAULT precision run in fp32 on the card too. A gathered element
costs one 32-byte DRAM sector at the HBM rate: a floor, in place of the
TPU's measured 5.5 ns an element.

The kernels' own bounds (``chip_smoke.py``'s ``kernels`` line) are
:class:`CostModel` builders here too (:func:`reference_dog_kernel_model`,
:func:`patch_gather_model`, :func:`score_tables_model`,
:func:`score_rows_model`, :func:`gather_resample_model`), read off the
shapes a call is given.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sift_parallel_optimization_tpu_torch.config import PyramidConfig, num_octaves
from sift_parallel_optimization_tpu_torch.core.pyramid_ref import _octave_scale_sigmas


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str                     # torch.cuda.get_device_name of the part
    hbm_gbps: float               # HBM bandwidth, GB/s (both directions together)
    matmul_f32_tflops: float      # fp32 matmul peak (no TF32): both matmul classes
    elementwise_tflops: float     # fp32 outside the tensor cores
    gather_bytes_per_elem: float  # DRAM bytes one gathered element moves
    link_gbps: float              # GPU-to-GPU link, GB/s each way


H100_SXM = Peaks(
    name="NVIDIA H100 80GB HBM3",
    hbm_gbps=3350.0,
    matmul_f32_tflops=67.0,
    elementwise_tflops=67.0,
    gather_bytes_per_elem=32.0,
    link_gbps=450.0,
)

PEAKS = {p.name: p for p in (H100_SXM,)}


def device_peaks(device) -> Peaks | None:
    """Peaks of the part ``device`` is: None for the CPU; raises for a CUDA
    part that has no entry in :data:`PEAKS`."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"no roofline for device type {device.type!r}")
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise ValueError(f"no published peaks for {name!r} in bench/roofline.PEAKS; "
                         f"add the part's figures before reading floors on it")
    return PEAKS[name]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Analytic cost of one workload (see module conventions)."""

    hbm_bytes: float = 0.0
    matmul_f32_flops: float = 0.0      # matmuls the JAX package runs at HIGHEST
    matmul_default_flops: float = 0.0  # matmuls the JAX package runs at DEFAULT
    elementwise_flops: float = 0.0     # elementwise / stencil flops
    gather_elems: float = 0.0
    note: str = ""

    def _times_s(self, peaks: Peaks) -> dict[str, float]:
        bw = peaks.hbm_gbps * 1e9
        return {
            "hbm": self.hbm_bytes / bw,
            "matmul": (self.matmul_f32_flops + self.matmul_default_flops)
            / (peaks.matmul_f32_tflops * 1e12),
            "elementwise": self.elementwise_flops / (peaks.elementwise_tflops * 1e12),
            "gather": self.gather_elems * peaks.gather_bytes_per_elem / bw,
        }

    def floor_ms(self, peaks: Peaks | None) -> float | None:
        if peaks is None:
            return None
        return 1e3 * max(self._times_s(peaks).values())

    def bound(self, peaks: Peaks | None) -> str | None:
        """The resource that sets the floor: hbm, matmul, elementwise or gather."""
        if peaks is None:
            return None
        return max(self._times_s(peaks).items(), key=lambda kv: kv[1])[0]

    def sol_pct(self, measured_ms: float, peaks: Peaks | None) -> float | None:
        if peaks is None:
            return None
        if measured_ms <= 0:
            return 0.0
        return round(100.0 * self.floor_ms(peaks) / measured_ms, 1)

    def kernel_bound(self, peaks: Peaks) -> tuple[float, str]:
        """(floor ms, "bytes" or "operations"): the ``kernels`` line's form."""
        by = "bytes" if self.bound(peaks) in ("hbm", "gather") else "operations"
        return self.floor_ms(peaks), by

    def __add__(self, other: "CostModel") -> "CostModel":
        return CostModel(
            hbm_bytes=self.hbm_bytes + other.hbm_bytes,
            matmul_f32_flops=self.matmul_f32_flops + other.matmul_f32_flops,
            matmul_default_flops=self.matmul_default_flops + other.matmul_default_flops,
            elementwise_flops=self.elementwise_flops + other.elementwise_flops,
            gather_elems=self.gather_elems + other.gather_elems,
            note=self.note,
        )


def _octave_sizes(length: int, n_octaves: int | None = None) -> list[int]:
    total = num_octaves(length)
    n = total if n_octaves is None else min(n_octaves, total)
    return [length // (2**o) for o in range(n)]


def _taps(sigma: float) -> int:
    return 2 * max(1, int(math.ceil(3.0 * sigma))) + 1


def _band_radius(sigma: float) -> int:
    """Half-width of a blur matrix's nonzero band (taps radius)."""
    return max(1, int(math.ceil(3.0 * sigma)))


def _base_sigma(cfg: PyramidConfig) -> float:
    return math.sqrt(max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12))


# ---------------------------------------------------------------------------
# Workload models (bench records)
# ---------------------------------------------------------------------------


def reference_pyramid_model(size: int, S: int) -> CostModel:
    """REFERENCE-mode window+DoG (the headline): pure elementwise.

    Per octave: read the base once, write S+3 output planes; one multiply
    per output element.
    """
    bytes_ = 0.0
    flops = 0.0
    for n in _octave_sizes(size):
        bytes_ += 4.0 * n * n * (1 + (S + 3))
        flops += 1.0 * (S + 3) * n * n
    return CostModel(hbm_bytes=bytes_, elementwise_flops=flops,
                     note=f"reference pyramid {size}^2 S={S}")


def sift_pyramid_model(cfg: PyramidConfig) -> CostModel:
    """True Gaussian pyramid: separable blurs of every octave base.

    Algorithmic flops: 2 passes x 2*(2r+1) flops per pixel per scale (the
    taps), charged as fp32 matmul work; minimal bytes: read each octave base
    once, write the S+3 planes once. The port's dense Toeplitz products
    issue far more (a 512-wide product per pixel), so its %SOL reads low:
    that is the distance to the banded blur, not a slip of the floor.
    """
    rel = _octave_scale_sigmas(cfg)
    bytes_ = 0.0
    flops = 0.0
    for o, n in enumerate(_octave_sizes(cfg.length, cfg.n_octaves)):
        per_px = sum(2 * 2 * _taps(s) for s in rel)
        if o == 0:
            per_px += 2 * 2 * _taps(_base_sigma(cfg))
        flops += per_px * n * n
        bytes_ += 4.0 * n * n * (1 + (cfg.S + 3))
    return CostModel(hbm_bytes=bytes_, matmul_f32_flops=flops,
                     note=f"sift pyramid {cfg.length}^2 S={cfg.S}")


def dense_score_model(cfg: PyramidConfig) -> CostModel:
    """Detection dense stage: DoG + 26-neighbour extrema + quadratic-fit
    ranking score + block-reduce tables. Minimal bytes: read the S+3
    Gaussian planes once per octave; ~60 flops a voxel on the (S, N-2, N-2)
    interior."""
    bytes_ = 0.0
    flops = 0.0
    for n in _octave_sizes(cfg.length, cfg.n_octaves):
        bytes_ += 4.0 * n * n * (cfg.S + 3)
        flops += 60.0 * cfg.S * max(n - 2, 0) ** 2
    return CostModel(hbm_bytes=bytes_, elementwise_flops=flops,
                     note=f"dense score {cfg.length}^2")


def refit_model(capacity: int, rounds: int = 2) -> CostModel:
    """Sparse candidate re-fit: 19-offset flat gathers per round."""
    return CostModel(gather_elems=float(capacity * 19 * rounds),
                     note=f"sparse refit K={capacity} x{rounds}")


def descriptor_model(cfg: PyramidConfig, capacity: int) -> CostModel:
    """Orientation + descriptor stage: the per-keypoint patch copy, the
    atlas build and the resample / histogram products.

    Copies count read plus write: the patch gather reads and writes each
    patch, the atlas build reads the pyramid and writes the padded atlas.
    The JAX module charged both one way (the larger of read and write),
    because the TPU's DMA engine sustained its rate in each direction at
    once; the H100's 3.35 TB/s is one figure for reads and writes together.
    """
    from sift_parallel_optimization_tpu_torch.models import descriptor as D

    item = float(torch.empty((), dtype=D.ATLAS_DTYPE).element_size())
    rows = D.patch_rows_for(D.max_patch_radius(cfg.S, cfg.sigma0))
    patch_bytes = capacity * rows * D.PATCH_COLS * item
    atlas_rows = 0.0
    pyr_bytes = 0.0
    for n in _octave_sizes(cfg.length, cfg.n_octaves):
        atlas_rows += (cfg.S + 3) * (2 * D.ROW_PAD + n)
        pyr_bytes += 4.0 * n * n * (cfg.S + 3)
    atlas_bytes = atlas_rows * (D.COL_PAD + cfg.length + 128) * item
    resample = 0.0
    for g in (D.ORI_GRID, D.DESC_GRID):
        resample += 2 * g * rows * D.PATCH_COLS
        resample += 2 * g * g * D.PATCH_COLS
    hist = 2 * (D.DESC_GRID - 2) ** 2 * (16 + 16 * 8)  # trilinear votes
    return CostModel(
        hbm_bytes=2.0 * patch_bytes + atlas_bytes + pyr_bytes,
        matmul_default_flops=capacity * (resample + hist),
        note=f"descriptors K={capacity}",
    )


def frontend_model(cfg: PyramidConfig, capacity: int) -> CostModel:
    """Full frontend floor: the sum of the stage models."""
    m = (sift_pyramid_model(cfg) + dense_score_model(cfg) + refit_model(capacity)
         + descriptor_model(cfg, capacity))
    return dataclasses.replace(m, note=f"frontend {cfg.length}^2 K={capacity}")


def matching_model(k: int, dim: int = 128) -> CostModel:
    """Descriptor matching: one (K, D) x (D, K) similarity product plus
    ratio / mutual reductions."""
    return CostModel(hbm_bytes=2.0 * k * dim * 4 + 4.0 * k * k,
                     matmul_default_flops=2.0 * k * k * dim, note=f"match {k}x{k}")


def stage_models(cfg: PyramidConfig, capacity: int) -> dict[str, CostModel]:
    """The frontend stage decomposition of ``cli bench --workloads stages``."""
    return {
        "pyramid": sift_pyramid_model(cfg),
        "dense_score": dense_score_model(cfg),
        "refit": refit_model(capacity),
        "descriptors": descriptor_model(cfg, capacity),
        "frontend": frontend_model(cfg, capacity),
    }


def tracking_step_cost(
    window: int = 6,
    pts_per_frame: int = 128,
    desc_capacity: int = 256,
    ba_iters: int = 4,
    n_hyp: int = 128,
) -> CostModel:
    """Analytic cost of one odometry TRACKING step (shift eviction +
    PnP/triangulation registration + window BA, once the window is full).

    * shift: one read + write of the window map;
    * register: the (2B, 128) x (P, 128) descriptor product, n_hyp minimal
      DLT solves and their scoring over P points, the 5-iteration refine
      and B triangulations;
    * window BA x ba_iters: residuals / Jacobians over M = 3*B*W
      observations, the (C, P) Schur reduction and the 6C x 6C solve.

    The floor is tens of microseconds: the step is bound by latency and
    small ops, which is what the record shows.
    """
    W, B = window, pts_per_frame
    C, P = W, W * B
    M = 3 * P
    map_bytes = (C * (3 + 3) * 4 + C + P * 3 * 4 + P + P * 128 * 4 + M * (4 + 4 + 8 + 1))
    hbm = 2.0 * map_bytes
    matmul_default = 2.0 * (2 * B) * P * 128
    hbm += (2 * B + P) * 128 * 4
    elementwise = n_hyp * 3.0e4 + n_hyp * P * 30.0 + 5 * P * 60.0 + B * 600.0
    elementwise += ba_iters * M * 570.0
    matmul_f32 = ba_iters * (
        2.0 * M * (36 + 9 + 18)
        + 2.0 * (6 * C) * (6 * C) * (3 * P)
        + 2.0 * (6 * C) ** 3 / 3.0
    )
    hbm += ba_iters * M * (4 + 4 + 8 + 1)
    return CostModel(hbm_bytes=hbm, matmul_f32_flops=matmul_f32,
                     matmul_default_flops=matmul_default, elementwise_flops=elementwise,
                     note="tracking step: shift + register + amortized window BA")


def loop_stage_cost(
    desc_capacity: int = 256,
    archive_slots: int = 8192,
    n_hyp: int = 128,
) -> CostModel:
    """Analytic cost of the per-frame LOOP stage of loop-closed odometry
    (archive write + archive-PnP propose + device-side accept); add it to
    :func:`tracking_step_cost` for the whole step.

    * archive write: one descriptor block (B, 128) + positions;
    * propose: the (K, 128) x (A, 128) similarity product and its stream,
      the top-2 / mutual reductions (one pass over K x A), n_hyp DLT
      hypotheses + scoring over K points;
    * accept: O(cap) elementwise, negligible.
    """
    K, A = desc_capacity, archive_slots
    hbm = (K + A) * 128.0 * 4 + A * 3 * 4
    hbm += 128 * (128 + 3 + 4 + 1) * 4.0
    matmul_default = 2.0 * K * A * 128
    elementwise = 3.0 * K * A
    elementwise += n_hyp * 3.0e4 + n_hyp * K * 30.0
    return CostModel(hbm_bytes=hbm, matmul_default_flops=matmul_default,
                     elementwise_flops=elementwise,
                     note="loop stage: archive write + archive-PnP propose + accept")


# ---------------------------------------------------------------------------
# Kernel models (chip_smoke.py's kernels line): each input read once, each
# output written once, for the shapes one call is given.
# ---------------------------------------------------------------------------


def reference_dog_kernel_model(n: int, S: int) -> CostModel:
    """Kernel 1 (``csrc/reference_dog.cu``) on an (n, n) image: the image
    read once (each octave's subsample is a part of it), S+3 planes of every
    octave written, ~4 flops an output (two window products, a difference,
    the base). :func:`reference_pyramid_model` charges each octave's base
    as a read of its own, as the JAX module does (4% more bytes)."""
    out = sum((S + 3) * (n >> o) ** 2 for o in range(num_octaves(n)))
    return CostModel(hbm_bytes=4.0 * (n * n + out), elementwise_flops=4.0 * out,
                     note=f"reference_dog kernel {n}^2 S={S}")


def patch_footprint_bytes(atlas_shape, ys: torch.Tensor, xs: torch.Tensor, rows: int,
                          cols: int) -> float:
    """Atlas bytes kernel 2a / 2b must read for these origins: the union of
    the (rows, cols) windows, each origin normalised as the kernel does
    (``ops/patch_gather._normalise``), counted per frame of a (B, R, C)
    atlas stack ((B, K) origins) or over one shared (R, C) atlas. Windows
    overlap (keypoints cluster) and leave parts of the atlas unread, so
    this is what the call's data needs, not the atlas size."""
    from sift_parallel_optimization_tpu_torch.ops.patch_gather import _normalise

    r, c = atlas_shape[-2:]
    y0, x0 = _normalise(ys, xs, r, c, rows, cols)
    y0, x0 = y0.reshape(-1, y0.shape[-1]), x0.reshape(-1, x0.shape[-1])
    frames = y0.shape[0] if len(atlas_shape) == 3 else 1
    y0, x0 = y0.reshape(frames, -1), x0.reshape(frames, -1)
    # Rectangles painted into a difference array, summed up: covered > 0.
    diff = torch.zeros((frames, r + 1, c + 1), dtype=torch.int32, device=ys.device)
    f = torch.arange(frames, device=ys.device)[:, None].expand_as(y0)
    one = torch.ones_like(y0, dtype=torch.int32)
    for dy, dx, sign in ((0, 0, 1), (rows, 0, -1), (0, cols, -1), (rows, cols, 1)):
        diff.index_put_((f, y0 + dy, x0 + dx), sign * one, accumulate=True)
    covered = diff.cumsum(1).cumsum(2)[:, :r, :c] > 0
    return float(covered.sum()) * 4.0


def patch_gather_model(n_patches: int, rows: int, cols: int, atlas_numel: int,
                       footprint_bytes: float | None = None) -> CostModel:
    """Kernel 2a / 2b (``csrc/patch_gather.cu``): the atlas pixels the
    windows cover read once (``footprint_bytes``, from
    :func:`patch_footprint_bytes`; without it, the patches' pixels up to
    the atlas size), two int32 origins a patch, every f32 patch written
    once."""
    patch = rows * cols * 4.0
    read = min(n_patches * patch, atlas_numel * 4.0)
    if footprint_bytes is not None:
        read = min(read, footprint_bytes)
    return CostModel(hbm_bytes=read + n_patches * (patch + 2 * 4.0),
                     note=f"patch gather {n_patches} x {rows}x{cols}")


def score_tables_model(shapes, frames: int) -> CostModel:
    """Kernel 3's block top-2 entry (``csrc/score_tables.cu``) on ``frames``
    frames of (planes, H, W) DoG octave ``shapes``: the flat DoG read, the
    tables written (12 bytes an entry, plus the dense octaves' f32 scores),
    ~130 flops a scored voxel."""
    from sift_parallel_optimization_tpu_torch.ops.score_tables import table_layout

    lay = table_layout(tuple(tuple(s) for s in shapes))
    dog = sum(p * h * w for p, h, w in shapes)
    out = sum(o.n * 12 + (o.vg * 4 if o.dense else 0) for o in lay)
    return CostModel(hbm_bytes=frames * (4.0 * dog + out),
                     elementwise_flops=frames * 130.0 * sum(o.vg for o in lay),
                     note=f"score tables block_top2 x{frames}")


def score_rows_model(planes: int, h: int, w: int) -> CostModel:
    """Kernel 3's rows entry on one (planes, h, w) DoG: the DoG read, one
    (f32, int32) entry per 64-column span written, ~130 flops a voxel."""
    vox = (planes - 2) * (h - 2) * (w - 2)
    entries = (planes - 2) * (h - 2) * -(-(w - 2) // 64)
    return CostModel(hbm_bytes=4.0 * planes * h * w + 8.0 * entries,
                     elementwise_flops=130.0 * vox, note=f"score tables rows {planes}x{h}x{w}")


def resample_footprint_bytes(params: torch.Tensor, atlas_numel: int) -> float:
    """Atlas bytes kernel 4 must read for (K, 4) keypoint ``params`` (centre
    row, centre column, orientation radius, descriptor radius): each
    keypoint's sample footprint, a square of side 2 * max radius + 2, and no
    more than the atlas holds."""
    side = 2 * torch.ceil(params[:, 2:4].amax(dim=1)) + 2
    return min(float((side * side).sum()) * 4.0, atlas_numel * 4.0)


def gather_resample_model(k: int, footprint_bytes: float) -> CostModel:
    """Kernel 4 (``csrc/gather_resample.cu``): the footprints read, both
    grids (18^2 + 26^2) and the (4 + 2) per-keypoint words written, ~16
    flops a sample."""
    grids = 18 * 18 + 26 * 26
    return CostModel(hbm_bytes=footprint_bytes + k * (grids + 4 + 2) * 4.0,
                     elementwise_flops=16.0 * k * grids, note=f"gather resample K={k}")


# ---------------------------------------------------------------------------
# Link cost model: per-device bytes of each sharded op (parallel/ on
# torch.distributed), and the scaling they project (bench/scaling.py).
# ---------------------------------------------------------------------------


def ring_all_reduce_bytes(array_bytes: float, n: int) -> float:
    """Per-device link bytes of a ring all-reduce (reduce-scatter + all-gather)."""
    return 2.0 * array_bytes * (n - 1) / n if n > 1 else 0.0


def ring_reduce_scatter_bytes(array_bytes: float, n: int) -> float:
    return array_bytes * (n - 1) / n if n > 1 else 0.0


def ring_all_gather_bytes(array_bytes: float, n: int) -> float:
    return array_bytes * (n - 1) / n if n > 1 else 0.0


def _sharded(n: int, n_spatial: int, max_r: int) -> bool:
    """Whether an octave of side n is row-sharded n_spatial ways (it needs
    an even split and room for the halo)."""
    return not (n % (2 * n_spatial) or n // n_spatial < max(2 * max_r, 8))


def sharded_pyramid_ici_bytes(cfg: PyramidConfig, n_spatial: int) -> float:
    """Per-device link bytes per frame of the row-sharded SIFT pyramid: one
    halo exchange per sharded blur-bank call, r rows each way; the tail
    octaves that cannot hold the halo run unsharded."""
    if n_spatial <= 1:
        return 0.0
    rel = _octave_scale_sigmas(cfg)
    base = _base_sigma(cfg)
    max_r = max(_band_radius(s) for s in [base, *rel])
    total = 0.0
    first = True
    for n in _octave_sizes(cfg.length, cfg.n_octaves):
        if not _sharded(n, n_spatial, max_r):
            break
        if first:  # the base blur's exchange at octave-0 size
            total += 2 * 2 * _band_radius(base) * n * 4.0
            first = False
        total += 2 * 2 * max_r * n * 4.0  # send + receive, up + down
    return total


def dp_frontend_ici_bytes() -> float:
    """Batch-sharded frontend: no collective inside the step."""
    return 0.0


def ba_cg_ici_bytes(n_cams: int, n_pts: int, n_dev: int, gn_iters: int = 10,
                    cg_iters: int = 25) -> float:
    """Per-device link bytes of the observation-sharded implicit-Schur CG BA
    per bundle_adjust call. Per GN step: an all-reduce of (C,6,6)+(C,6) and
    a reduce-scatter of (P,3,3)+(P,3); per CG matvec: a reduce-scatter and
    an all-gather of (P,3) and an all-reduce of (C,6)."""
    c_blocks = (n_cams * 36 + n_cams * 6) * 4.0
    p_blocks = (n_pts * 9 + n_pts * 3) * 4.0
    per_gn = ring_all_reduce_bytes(c_blocks, n_dev) + ring_reduce_scatter_bytes(p_blocks, n_dev)
    per_matvec = (ring_reduce_scatter_bytes(n_pts * 3 * 4.0, n_dev)
                  + ring_all_gather_bytes(n_pts * 3 * 4.0, n_dev)
                  + ring_all_reduce_bytes(n_cams * 6 * 4.0, n_dev))
    return gn_iters * (per_gn + cg_iters * per_matvec)


def ring_matching_ici_bytes(n_frames: int, kp_per_frame: int, n_dev: int,
                            desc_dtype_bytes: int = 4) -> float:
    """Per-device link bytes of one ring pairwise-matching sweep: each
    device forwards its descriptor block + valid mask on every one of the
    n_dev ring steps."""
    f_loc = -(-n_frames // n_dev)
    block = f_loc * kp_per_frame * (128.0 * desc_dtype_bytes + 1.0)
    return n_dev * block


def projected_efficiency(single_chip_ms: float, n: int, ici_bytes_per_dev: float,
                         peaks: Peaks) -> float:
    """Projected strong-scaling efficiency at n devices: a perfect compute
    split plus the link time at ``peaks.link_gbps`` (no overlap)."""
    if n <= 1:
        return 1.0
    t_comp = single_chip_ms / n
    t_link = 1e3 * ici_bytes_per_dev / (peaks.link_gbps * 1e9)
    return round(single_chip_ms / (n * (t_comp + t_link)), 3)


def projected_efficiency_overlap(single_chip_ms: float, n: int, ici_bytes_per_dev: float,
                                 dep_fraction: float, peaks: Peaks, *,
                                 exchange_latency_us: float, n_exchanges: int = 1) -> float:
    """Strong-scaling projection with the halo exchange overlapped by the
    halo-independent share of the compute:

        t_step = max(t_indep, t_link) + t_dep,
        t_link = bytes / link rate + n_exchanges * exchange latency.

    ``dep_fraction`` is the halo-dependent share of the per-device compute;
    ``exchange_latency_us`` is the caller's figure for one exchange (no
    published one exists for the part: state where it came from).
    """
    if n <= 1:
        return 1.0
    t_comp = single_chip_ms / n
    t_link = (1e3 * ici_bytes_per_dev / (peaks.link_gbps * 1e9)
              + n_exchanges * exchange_latency_us * 1e-3)
    t_dep = t_comp * dep_fraction
    return round(t_comp / (max(t_comp - t_dep, t_link) + t_dep), 3)


def sharded_pyramid_overlap_model(cfg: PyramidConfig, n_spatial: int) -> tuple[float, int]:
    """(dep_fraction, n_exchanges) of the row-sharded SIFT pyramid, flops-
    weighted over the octaves: a blur-bank call's halo-dependent share is
    ~2r/(h + 2r)."""
    if n_spatial <= 1:
        return 0.0, 0
    rel = _octave_scale_sigmas(cfg)
    base = _base_sigma(cfg)
    max_r = max(_band_radius(s) for s in [base, *rel])
    flops_dep = 0.0
    flops_tot = 0.0
    n_ex = 0
    first = True
    for size in _octave_sizes(cfg.length, cfg.n_octaves):
        sharded = _sharded(size, n_spatial, max_r)
        h = size // n_spatial if sharded else size
        calls = []
        if first:
            calls.append(_band_radius(base))
            first = False
        calls.append(max_r)
        for r in calls:
            # column pass (h+2r rows x size) + row pass (h x (h+2r) band).
            f = (h + 2 * r) * size + h * (2 * r + 1) * size
            flops_tot += f
            if sharded:
                n_ex += 1
                flops_dep += f * (2.0 * r) / (h + 2 * r)
    return (flops_dep / flops_tot) if flops_tot else 0.0, n_ex
