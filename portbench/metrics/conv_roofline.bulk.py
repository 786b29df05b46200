"""conv_roofline.bulk: the least time of the program's layers (8 convs
and the dense head) for the images of the calls that ran wholly inside
the traced window, over the device time of the kernels that compute
them, in percent.

The least time of a layer is the longer of its operations at the int8
peak and its bytes at the HBM rate (`portbench.roofline`); the kernels
are matched by the name parts below, so the work counted is the same
whichever kernel computes it.
"""

from portbench import roofline

KERNELS = ("conv_mma_kernel", "trunk_kernel")


def read(run):
    tr, loop = run["trace"], run["loop"]
    if tr is None:
        return None
    calls = [c for c in loop.calls
             if c["t_submit"] >= tr.t0 and c["t_done"] <= tr.t1]
    spent = tr.kernel_s(KERNELS)
    if not calls or spent <= 0:
        return None
    least = len(calls) * roofline.cnn_least_s(run["sizes"], loop.batch)
    return 100.0 * least / spent
