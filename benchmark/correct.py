"""The comparison that decides ``correct``: a run's features against the
plain reference's, keypoint by keypoint.

Each frame's valid keypoint slots on both sides (primary and secondary
orientations pooled) are paired: same octave and scale, centres within
``MATCH_PX`` octave pixels on both axes and orientations within
``MATCH_RAD``, nearest first, each slot in one pair at most. A pair
agrees when every gap is within its tolerance (``TOL``): the refined
position in octave pixels on either axis and in scale steps (``fit``),
the orientation in radians (``ori``), the largest descriptor element
(``desc``) and the contrast in units of the contrast threshold
(``contrast``). The numbers compared, over all the frames checked:

* ``unpaired``: the share of valid slots, both sides counted, left
  without a pair (keypoints found on one side only, or moved or turned
  beyond the pairing window);
* ``off_pairs``: the share of pairs that do not agree.

A sound run leaves a few keypoints in ten thousand unpaired or off: those
whose contrast, edge or offset test, or refinement hop, sits within
rounding of its threshold. Each number has a limit in the configuration's
``limits``; the run is correct when both are at or under their limits and
the frames checked hold at least one valid keypoint. The widest gaps are
reported beside them (``widest``), not compared.
"""

from __future__ import annotations

import math

import numpy as np

MATCH_PX = 1.0
MATCH_RAD = 0.2
TOL = {"fit": 0.005, "ori": 0.002, "desc": 0.002, "contrast": 0.002}
NUMBERS = ("unpaired", "off_pairs")
FIELDS = ("x", "y", "sigma", "score", "orientation", "octave", "scale", "valid", "desc")


def as_numpy(feats: dict) -> dict:
    """Every field of a features dict as a float64 / int64 / bool array."""
    out = {}
    for name in FIELDS:
        v = feats[name]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        out[name] = v if v.dtype == bool else v.astype(
            np.int64 if name in ("octave", "scale") else np.float64)
    return out


def _circular(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.abs(a - b) % (2 * math.pi)
    return np.minimum(d, 2 * math.pi - d)


def pair_frame(prog: dict, ref: dict) -> tuple[np.ndarray, np.ndarray]:
    """Slot indices (prog, ref) of the pairs of one frame."""
    pi, ri = np.flatnonzero(prog["valid"]), np.flatnonzero(ref["valid"])
    pairs_p, pairs_r = [], []
    groups = {}
    for side, idx, f in ((0, pi, prog), (1, ri, ref)):
        for i in idx:
            groups.setdefault((int(f["octave"][i]), int(f["scale"][i])), ([], []))[side].append(i)
    for (octave, _scale), (gp, gr) in groups.items():
        if not gp or not gr:
            continue
        gp, gr = np.asarray(gp), np.asarray(gr)
        unit = 2.0 ** octave
        dx = np.abs(prog["x"][gp][:, None] - ref["x"][gr][None, :]) / unit
        dy = np.abs(prog["y"][gp][:, None] - ref["y"][gr][None, :]) / unit
        dt = _circular(prog["orientation"][gp][:, None], ref["orientation"][gr][None, :])
        ok = (dx <= MATCH_PX) & (dy <= MATCH_PX) & (dt <= MATCH_RAD)
        cost = np.where(ok, np.maximum(dx, dy) + dt, np.inf)
        cand = np.argwhere(ok)
        order = np.argsort(cost[ok], kind="stable")
        used_p, used_r = set(), set()
        for a, b in cand[order]:
            if a not in used_p and b not in used_r:
                used_p.add(a)
                used_r.add(b)
                pairs_p.append(gp[a])
                pairs_r.append(gr[b])
    return np.asarray(pairs_p, np.int64), np.asarray(pairs_r, np.int64)


def frame_stats(prog: dict, ref: dict, cfg: dict) -> dict:
    """Counts of one frame's slots and pairs, and the widest gap of each kind."""
    p, r = pair_frame(prog, ref)
    out = {"valid": int(prog["valid"].sum()), "valid_ref": int(ref["valid"].sum()),
           "paired": len(p), "off": 0, **{k: 0.0 for k in TOL}}
    if not len(p):
        return out
    unit = 2.0 ** prog["octave"][p]
    pos = np.maximum(np.abs(prog["x"][p] - ref["x"][r]), np.abs(prog["y"][p] - ref["y"][r]))
    thr = cfg["contrast_threshold"] / cfg["S"]
    gaps = {
        "fit": np.maximum(pos / unit, cfg["S"] * np.abs(np.log2(prog["sigma"][p] / ref["sigma"][r]))),
        "ori": _circular(prog["orientation"][p], ref["orientation"][r]),
        "desc": np.abs(prog["desc"][p] - ref["desc"][r]).max(axis=1),
        "contrast": np.abs(prog["score"][p] - ref["score"][r]) / thr,
    }
    off = np.zeros(len(p), bool)
    for k, g in gaps.items():
        off |= ~(g <= TOL[k])
        out[k] = float(g.max())
    out["off"] = int(off.sum())
    return out


def numbers(stats: list[dict]) -> dict:
    """The compared numbers over the frames' stats."""
    total = sum(s["valid"] + s["valid_ref"] for s in stats)
    paired = sum(s["paired"] for s in stats)
    return {"unpaired": (total - 2 * paired) / total if total else 1.0,
            "off_pairs": sum(s["off"] for s in stats) / paired if paired else 1.0}


def widest(stats: list[dict]) -> dict:
    """The widest gap of each kind over the frames' pairs."""
    return {k: max((s[k] for s in stats), default=0.0) for k in TOL}


def verdict(nums: dict, limits: dict, stats: list[dict]) -> tuple[bool, list[tuple]]:
    """(correct, [(name, value, limit), ...]): every number at or under its
    limit, and at least one valid keypoint on the program's side."""
    rows = [(name, nums[name], limits[name]) for name in NUMBERS]
    ok = all(v <= lim for _n, v, lim in rows) and sum(s["valid"] for s in stats) > 0
    return ok, rows
