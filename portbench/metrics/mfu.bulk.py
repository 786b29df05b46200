"""mfu.bulk: the logical operations of the images whose calls ran wholly
inside the traced window (every conv layer and the head, from their
shapes), over the traced window's seconds and the int8 peak, in
percent: the whole call's share of the card."""

from portbench import roofline


def read(run):
    tr, loop = run["trace"], run["loop"]
    if tr is None:
        return None
    n = sum(loop.batch for c in loop.calls
            if c["t_submit"] >= tr.t0 and c["t_done"] <= tr.t1)
    if not n:
        return None
    ops = n * roofline.cnn_ops_per_image(run["sizes"])
    return 100.0 * ops / tr.window_s() / roofline.PEAK_INT8_OPS
