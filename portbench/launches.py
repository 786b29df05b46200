"""The device's launches of the CNN's conv kernel in a traced window,
each assigned to the layer of the program that it computes.

Kernel 1 (``conv_mma_kernel``) computes every layer of the program, the
dense head too, one launch a layer, so its name in the trace does not
tell the layers apart.  Their order does: the bulk loop enqueues on one
stream, and each call launches kernel 6 (``thermo_kernel``, the input's
encoding) and then kernel 1 once for each layer, in order.  So the
window's operations, in the order they ran, are cut into calls at each
kernel-6 launch, and the i-th kernel-1 launch of a call computes layer
i.  A call with another count of kernel-1 launches than the program has
layers (an operation missing from the trace) is left out.  A window is
not read (the readers get None) where no call is whole, where the
launches of one layer do not share one kernel instantiation, or where a
trunk kernel (the ``fused`` backend) computes some layers.
"""

from __future__ import annotations

from portbench import roofline

KERNEL = "conv_mma_kernel"
CALL = "thermo_kernel"
TRUNK = "trunk_kernel"


def layer_device_s(run) -> tuple[list[float], int] | None:
    """(device seconds of each layer of `roofline.cnn_layers`, whole
    calls) in the traced window, each launch clipped to the window as
    `DeviceTrace.kernel_s` clips it; None where the window is not read."""
    tr = run["trace"]
    if tr is None or any(TRUNK in n for n, _, _ in tr.events):
        return None
    n_layers = len(roofline.cnn_layers(run["sizes"]))
    calls: list[list] = []
    for s, e, n in sorted((s, e, n) for n, s, e in tr.events):
        if CALL in n:
            calls.append([])
        elif KERNEL in n and calls:
            calls[-1].append((s, e, n))
    whole = [c for c in calls if len(c) == n_layers]
    if not whole:
        return None
    spent = [0.0] * n_layers
    for i in range(n_layers):
        if len({c[i][2] for c in whole}) != 1:
            return None
        spent[i] = sum(max(0.0, min(e, tr.t1) - max(s, tr.t0))
                       for s, e, _ in (c[i] for c in whole))
    return spent, len(whole)


def group_roofline(run, keep) -> float | None:
    """The least time of the layers that ``keep(layer)`` selects (a
    layer of `roofline.cnn_layers`), for every whole call in the traced
    window, over the device time of their launches, in percent."""
    got = layer_device_s(run)
    if got is None:
        return None
    spent, calls = got
    n = run["loop"].batch
    least = time = 0.0
    for layer, t in zip(roofline.cnn_layers(run["sizes"]), spent):
        if keep(layer):
            least += calls * roofline.least_s(
                n * roofline.conv_ops(layer), roofline.conv_bytes(layer, n),
                roofline.PEAK_INT8_OPS)
            time += t
    return 100.0 * least / time if time > 0 else None
