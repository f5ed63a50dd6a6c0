"""Host ms of the window's FASTQ parsing and batch staging (the
program's run.read spans)."""

from benchmark import spans


def read(ctx):
    return spans.total_ms("run.read")
