"""Kernel floors at the card's published peaks: frozen copies of the
program's ``bench/roofline.py`` builders (and of the layout arithmetic they
read), so that a later change to the program does not move the yardstick.

Conventions, as in the original: each input byte is read once and each
output byte written once; the floor is the larger of bytes over the HBM
rate and operations over the fp32 rate. Peaks are NVIDIA's published
figures for the part ``torch.cuda.get_device_name`` names (the H100 SXM5
80 GB: 3.35 TB/s HBM3, 67 TFLOP/s fp32 outside the tensor cores); a part
without an entry has no floor.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    hbm_gbps: float
    matmul_f32_tflops: float
    matmul_bf16_tflops: float
    elementwise_tflops: float
    gather_bytes_per_elem: float
    link_gbps: float


H100_SXM = Peaks(
    name="NVIDIA H100 80GB HBM3",
    hbm_gbps=3350.0,
    matmul_f32_tflops=67.0,
    matmul_bf16_tflops=989.0,
    elementwise_tflops=67.0,
    gather_bytes_per_elem=32.0,
    link_gbps=450.0,
)

PEAKS = {p.name: p for p in (H100_SXM,)}


@dataclasses.dataclass(frozen=True)
class CostModel:
    hbm_bytes: float = 0.0
    elementwise_flops: float = 0.0

    def floor_ms(self, peaks: Peaks) -> float:
        return 1e3 * max(self.hbm_bytes / (peaks.hbm_gbps * 1e9),
                         self.elementwise_flops / (peaks.elementwise_tflops * 1e12))


# --- kernel 3: score tables ---------------------------------------------------

SPAN = 64
DENSE_BELOW = 4096


def table_entries(shapes) -> list[tuple[int, bool, int]]:
    """(entries, dense, score voxels) of each (planes, H, W) DoG octave in
    kernel 3's tables (``ops/score_tables.table_layout``)."""
    out = []
    for planes, h, w in shapes:
        vg = (planes - 2) * (h - 2) * (w - 2)
        dense = vg < DENSE_BELOW
        out.append((vg if dense else 2 * (-(-vg // SPAN)), dense, vg))
    return out


def score_tables_model(shapes, frames: int) -> CostModel:
    """Kernel 3 on ``frames`` frames of DoG octave ``shapes``: the flat DoG
    read, the tables written (12 bytes an entry, plus the dense octaves' f32
    scores), ~130 flops a scored voxel."""
    lay = table_entries(shapes)
    dog = sum(p * h * w for p, h, w in shapes)
    out = sum(n * 12 + (vg * 4 if dense else 0) for n, dense, vg in lay)
    return CostModel(hbm_bytes=frames * (4.0 * dog + out),
                     elementwise_flops=frames * 130.0 * sum(vg for _n, _d, vg in lay))


# --- kernel 2a / 2b: patch gather ---------------------------------------------

ROW_ALIGN = 8
ROW_PAD = 64
COL_PAD = 128
PATCH_ROWS = 128
PATCH_COLS = 256
MAX_RADIUS = 52


def max_patch_radius(S: int, sigma0: float) -> int:
    """``models/descriptor.max_patch_radius``."""
    sig_max = sigma0 * 2.0 ** ((S + 0.6) / S)
    rad_d = 3.0 * sig_max * math.sqrt(2.0) * (4 + 1) / 2
    rad_o = 3.0 * 1.5 * sig_max
    return min(MAX_RADIUS, int(math.ceil(max(rad_d, rad_o))) + 1)


def patch_rows_for(max_radius: int) -> int:
    need = 2 * (max_radius + 1) + ROW_ALIGN
    return min(PATCH_ROWS, -(-need // ROW_ALIGN) * ROW_ALIGN)


def _roundup(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def atlas_layout(shapes) -> dict:
    """The descriptor atlas of Gaussian octaves of (scales, H, W) ``shapes``
    (``models/descriptor._atlas_static``): per octave its first row, band
    height and column limit, and the atlas' rows and columns."""
    wlim = [_roundup(w, 128) for _s, _h, w in shapes]
    hprime = [2 * ROW_PAD + _roundup(h, ROW_ALIGN) for _s, h, _w in shapes]
    row_off, r = [], 0
    for (s, _h, _w), hp in zip(shapes, hprime):
        row_off.append(r)
        r += s * hp
    return {"row_off": np.asarray(row_off), "hprime": np.asarray(hprime),
            "wlim": np.asarray(wlim), "n_rows": r,
            "n_cols": max(COL_PAD + wl + 128 for wl in wlim)}


def patch_origins(lay: dict, kp: dict, max_radius: int, rows: int):
    """(row, column) origins of the keypoint slots' patches in the atlas
    (``models/descriptor._patch_origins``), in float32 as the program
    forms them."""
    f32 = np.float32
    o = np.clip(kp["octave"], 0, len(lay["hprime"]) - 1)
    inv = np.exp2(-o.astype(f32))
    ya = kp["y"].astype(f32) * inv + f32(ROW_PAD)
    xa = kp["x"].astype(f32) * inv + f32(COL_PAD)
    hp, wl, ro = lay["hprime"][o], lay["wlim"][o], lay["row_off"][o]
    y0 = np.clip((np.floor((ya - f32(max_radius)) / f32(ROW_ALIGN)) * ROW_ALIGN).astype(np.int64),
                 0, hp - rows)
    x0 = np.clip((np.floor((xa - f32(max_radius + 1.0)) / f32(128.0)) * 128).astype(np.int64),
                 0, wl)
    return ro + kp["scale"] * hp + y0, x0


def patch_footprint_bytes(atlas_rows: int, atlas_cols: int, ys, xs, rows: int,
                          cols: int) -> float:
    """Atlas bytes the gather must read for one frame's origins: the union
    of the (rows, cols) windows (``bench/roofline.patch_footprint_bytes``),
    each origin normalised as the kernel does."""
    ys, xs = np.asarray(ys, np.int64), np.asarray(xs, np.int64)
    y0 = np.clip(np.where(ys < 0, ys + atlas_rows, ys), 0, atlas_rows - rows)
    x0 = np.clip(np.where(xs < 0, xs + atlas_cols, xs), 0, atlas_cols - cols)
    diff = np.zeros((atlas_rows + 1, atlas_cols + 1), np.int32)
    for dy, dx, sign in ((0, 0, 1), (rows, 0, -1), (0, cols, -1), (rows, cols, 1)):
        np.add.at(diff, (y0 + dy, x0 + dx), sign)
    covered = diff.cumsum(0).cumsum(1)[:atlas_rows, :atlas_cols] > 0
    return float(covered.sum()) * 4.0


def patch_gather_model(n_patches: int, rows: int, cols: int, atlas_numel: int,
                       footprint_bytes: float) -> CostModel:
    """Kernel 2a / 2b: the atlas pixels the windows cover read once, two
    int32 origins a patch, every f32 patch written once."""
    patch = rows * cols * 4.0
    read = min(n_patches * patch, atlas_numel * 4.0, footprint_bytes)
    return CostModel(hbm_bytes=read + n_patches * (patch + 2 * 4.0))
