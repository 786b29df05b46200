"""k7_roofline.llm: the least time of every projection of the forwards
that ran wholly inside the traced window, at their real rows (a
prefill's computed prompt tokens, a decode step's live slots; not the
bucket's padding), over the device time of kernel 7, in percent.

A projection's least time is the longer of 2*M*K*N at the bf16 peak and
its bytes (packed weights, x and out once) at the HBM rate
(`portbench.roofline`).
"""

from portbench import roofline

KERNELS = ("ternary_mm_tc_kernel", "ternary_mm_f32_kernel")


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    dims = run["system"].shape(run["sizes"])
    least = 0.0
    for name, a, b, args in run["program_spans"]:
        if not (tr.t0 <= a and b <= tr.t1):
            continue
        if name == "prefill":
            least += roofline.packed_forward_least_s(dims, args["computed"])
        elif name == "decode":
            least += roofline.packed_forward_least_s(dims, args["live"])
    spent = tr.kernel_s(KERNELS)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
