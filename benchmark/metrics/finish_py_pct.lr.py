"""Percent of the window's finished long-read segments (those that reach a
Reg) that the LR mapper finished per record in Python, not from the
chunk's packed fix-and-rescore rows (stats finish_py_segments over
finish_segments)."""


def read(ctx):
    s = ctx["stats"]
    if not s.get("finish_segments"):
        return None
    return 100.0 * s.get("finish_py_segments", 0) / s["finish_segments"]
