"""Percent of the window's DP segments beyond the largest device bucket,
aligned by the host's scalar DP (stats host_dp_segments over
dp_segments)."""


def read(ctx):
    s = ctx["stats"]
    if not s.get("dp_segments"):
        return None
    return 100.0 * s.get("host_dp_segments", 0) / s["dp_segments"]
