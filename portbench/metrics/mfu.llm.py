"""mfu.llm: the logical FLOPs of the traced window over its seconds and
the bf16 peak, in percent: every prefill that ran wholly inside it (its
computed prompt tokens through every projection, causal attention at
their real lengths, the sampled row's head), and each request's decode
rows (one row a step at its real position) in the share of its decoding
time that fell inside it."""

from portbench import roofline


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    dims = run["system"].shape(run["sizes"])
    flops = 0.0
    for name, a, b, args in run["program_spans"]:
        if name == "prefill" and tr.t0 <= a and b <= tr.t1:
            flops += roofline.decoder_flops(dims, args["computed"],
                                            args.get("cached", 0))
    for r in run["loop"].requests:
        if "t_first" not in r or not r.get("tokens"):
            continue
        a, b = r["t_first"], r["t_done"]
        inside = max(0.0, min(b, tr.t1) - max(a, tr.t0))
        if b <= a or inside <= 0:
            continue
        p = len(r["prompt"])
        rows = sum(roofline.decoder_flops(dims, 1, p + j)
                   for j in range(len(r["tokens"]) - 1))
        flops += rows * inside / (b - a)
    if flops <= 0:
        return None
    return 100.0 * flops / tr.window_s() / roofline.PEAK_BF16_FLOPS
