"""Host ms of LongReadMapper._tail_batch (fetch, finish, oracle
fallbacks on the -t pool) per batch, mean over the window."""


def read(ctx):
    v = ctx["host_tail_ms"]
    return sum(v) / len(v) if v else None
