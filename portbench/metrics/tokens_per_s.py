"""tokens_per_s: generated tokens delivered to clients inside the window
(each finished request delivers its tokens when the step that finishes
it returns), over the window's seconds (host clock)."""


def read(run):
    w = run["window"]
    n = sum(len(r["tokens"]) for r in run["loop"].requests
            if r.get("tokens") and r["t_done"] <= w["t_end"])
    return n / w["seconds"]
