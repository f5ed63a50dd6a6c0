"""Host ms of writing the window's SAM records (the program's
run.write spans)."""

from benchmark import spans


def read(ctx):
    return spans.total_ms("run.write")
