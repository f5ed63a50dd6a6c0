"""Percent of the reads sent to the long-read device front that its meta
sent back to the oracle (stats front_fallback_reads over front_reads)."""


def read(ctx):
    s = ctx["stats"]
    if not s.get("front_reads"):
        return None
    return 100.0 * s.get("front_fallback_reads", 0) / s["front_reads"]
