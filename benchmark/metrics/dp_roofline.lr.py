"""Share of the long-read band DP and backtrack's roofline
(benchmark/roofline.py)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx)
