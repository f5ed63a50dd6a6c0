"""Percent of the window's wall time with no device operation running
(torch.profiler)."""


def read(ctx):
    if not ctx["events"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
