"""ttft_p90_ms: the 90th percentile (linear between ranks) over every
request whose first token reached the host inside the window, from its
submit to the return of the engine step that sampled that token (host
clock)."""

import numpy as np


def read(run):
    t_end = run["window"]["t_end"]
    v = [(r["t_first"] - r["t_submit"]) * 1e3 for r in run["loop"].requests
         if "t_first" in r and r["t_first"] <= t_end]
    return float(np.percentile(v, 90)) if v else None
