"""decode_step_ms.llm: the median length of the executor's own ``decode``
spans (one step of every slot) that began in the window's untraced part
(the profiler slows the host)."""

import numpy as np


def read(run):
    w = run["window"]
    v = [(b - a) * 1e3 for n, a, b, _ in run["program_spans"]
         if n == "decode" and run["t_untraced"] <= a < w["t_end"]]
    return float(np.median(v)) if v else None
