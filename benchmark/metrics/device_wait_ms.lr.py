"""Host ms waiting on the device: the front's meta and every DP
chunk's D2H (the program's lr.front_wait and lr.dp_wait spans)."""

from benchmark import spans


def read(ctx):
    return spans.total_ms("lr.front_wait", "lr.dp_wait")
