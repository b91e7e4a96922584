"""Share of the traced items' window in which no operation ran on the
device (torch.profiler, the union of the device operations' intervals)."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
