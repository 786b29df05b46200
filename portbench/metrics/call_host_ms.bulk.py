"""call_host_ms.bulk: the median host time of one call's enqueue (the
image copy, encode_image_ternary and CutiePipeline.run, the copy back),
until those calls return, over every call that began in the window's
untraced part (the profiler slows the host)."""

import numpy as np


def read(run):
    w = run["window"]
    v = [(b - a) * 1e3 for n, a, b in run["loop"].spans
         if n == "enqueue" and run["t_untraced"] <= a < w["t_end"]]
    return float(np.median(v)) if v else None
