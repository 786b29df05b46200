"""images_per_s: images whose class scores reached the host inside the
window, over the window's seconds (host clock)."""


def read(run):
    w, loop = run["window"], run["loop"]
    done = sum(loop.batch for c in loop.calls if c["t_done"] <= w["t_end"])
    return done / w["seconds"]
