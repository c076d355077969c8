"""``frame_ms_p95``: the 95th percentile over every frame of the window of
the time from the frame's due time on the camera clock to its features'
completion on the device (seen by the host on an event recorded after the
program's call). Host clock; open-loop units only."""

import numpy as np


def read(run):
    lat = [(u["done"] - u["due"]) * 1e3 for u in run.units if "due" in u]
    return float(np.percentile(lat, 95)) if lat else None
