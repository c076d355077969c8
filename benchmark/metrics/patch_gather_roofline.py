"""``patch_gather_roofline.<split>``: kernel 2a / 2b
(``patch_gather_kernel``, ``csrc/patch_gather.cu``) against its floor: the
frozen copy of the program's ``patch_gather_model``, each traced unit's
atlas footprint counted from the keypoint slots that unit produced, at the
card's published peaks, over the kernel's device time in the trace. None
without the kernel in the trace, without the traced units' keypoints, or
without peaks for the card."""

from benchmark import roofline

KERNEL = "patch_gather_kernel"


def read(run):
    peaks = roofline.PEAKS.get(run.device_name)
    if not run.trace or peaks is None or not run.traced_keypoints:
        return None
    ops = [op for op in run.trace.ops_in(run.trace.spans_named("sift.describe"))
           if KERNEL in op.name]
    units = sorted(run.traced_keypoints)
    if len(ops) != len(units):
        return None
    cfg = run.cfg
    shapes = [(cfg["S"] + 3, h, w) for h, w in run.octaves]
    lay = roofline.atlas_layout(shapes)
    radius = roofline.max_patch_radius(cfg["S"], cfg["sigma0"])
    rows, cols = roofline.patch_rows_for(radius), roofline.PATCH_COLS
    floor = 0.0
    for i in units:
        frames = run.traced_keypoints[i]
        foot, n = 0.0, 0
        for kp in frames:
            prim = {k: v[:cfg["max_keypoints"]] for k, v in kp.items()}
            ys, xs = roofline.patch_origins(lay, prim, radius, rows)
            foot += roofline.patch_footprint_bytes(lay["n_rows"], lay["n_cols"], ys, xs,
                                                   rows, cols)
            n += len(ys)
        model = roofline.patch_gather_model(n, rows, cols,
                                            len(frames) * lay["n_rows"] * lay["n_cols"], foot)
        floor += model.floor_ms(peaks)
    return 100.0 * floor / (sum(op.dur for op in ops) / 1e3)
