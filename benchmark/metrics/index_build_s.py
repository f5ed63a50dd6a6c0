"""Seconds of the port's build_index on the genome (host clock, ending in
a device sync), from set-up."""


def read(ctx):
    return ctx["setup"].get("index_build_s")
