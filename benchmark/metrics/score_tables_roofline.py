"""``score_tables_roofline.<split>``: kernel 3 (``score_block_top2_kernel``,
``csrc/score_tables.cu``) against its floor: the frozen copy of the
program's ``score_tables_model`` over the launches' frames of the cell's
DoG octaves, at the card's published peaks, over the kernel's device time
in the trace. None without the kernel in the trace or without peaks for
the card."""

from benchmark import roofline

KERNEL = "score_block_top2_kernel"


def read(run):
    peaks = roofline.PEAKS.get(run.device_name)
    if not run.trace or peaks is None:
        return None
    ops = [op for op in run.trace.ops_in(run.trace.spans_named("sift.detect"))
           if KERNEL in op.name]
    if not ops:
        return None
    planes = run.cfg["S"] + 2
    shapes = [(planes, h, w) for h, w in run.octaves]
    floor = roofline.score_tables_model(shapes, run.mix["batch"]).floor_ms(peaks)
    return 100.0 * floor * len(ops) / (sum(op.dur for op in ops) / 1e3)
