"""Percent of the window's long reads mapped by the scalar oracle
(stats fallback_reads over n_reads)."""


def read(ctx):
    s = ctx["stats"]
    if not s.get("n_reads"):
        return None
    return 100.0 * s.get("fallback_reads", 0) / s["n_reads"]
