"""Host ms of the long-read mapper's scalar-oracle phase over the
window (the program's lr.oracle spans, wall time of the -t pool)."""

from benchmark import spans


def read(ctx):
    return spans.total_ms("lr.oracle")
