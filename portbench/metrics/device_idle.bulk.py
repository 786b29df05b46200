"""device_idle.bulk: the share of the traced window in which no operation
ran on the device (torch.profiler's CUDA activity), in percent."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
