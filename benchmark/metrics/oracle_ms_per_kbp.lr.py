"""Oracle ms per kbp: the summed lr.oracle_read spans (one per read,
on the pool's threads) over the stats' oracle_bases / 1,000."""

from benchmark import spans


def read(ctx):
    kbp = ctx["stats"].get("oracle_bases", 0) / 1e3
    t = spans.window_spans()
    if t is None or kbp <= 0:
        return None
    ms = [s.end - s.start for s in t[1] if s.name == "lr.oracle_read"]
    return sum(ms) / 1e6 / kbp if ms else None
