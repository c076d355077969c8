"""``frames_per_s``: frames whose features completed on the device inside
the window, over the window's seconds. Host clock (device markers placed
on it)."""


def read(run):
    end = run.t0 + run.seconds
    done = sum(u["frames"] for u in run.units if u["done"] <= end)
    return done / run.seconds if done else None
