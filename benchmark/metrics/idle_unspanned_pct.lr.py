"""Percent of the window's wall time in which no device operation runs
(ctx["events"], torch.profiler) and no program span below the run root
is open: the device's idle time that the trace puts down to nothing."""

from benchmark import spans


def read(ctx):
    t = spans.window_spans()
    if t is None or not ctx["window_s"]:
        return None
    t0 = t[0].start  # ns; seconds from the root keep their precision
    busy = [((s.start - t0) / 1e9, (s.end - t0) / 1e9) for s in t[1]]
    busy += [((a - t0 / 1e3) / 1e6, (b - t0 / 1e3) / 1e6) for _, a, b in ctx["events"]]
    return 100.0 * (ctx["window_s"] - spans.union_s(busy)) / ctx["window_s"]
