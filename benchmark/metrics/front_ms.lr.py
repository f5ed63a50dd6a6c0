"""Device ms from a long-read batch's start to the mapper's front mark
(encode, sketch, lookup, both votes), CUDA events, mean per batch."""


def read(ctx):
    v = [b["front"] for b in ctx["lr_batches"] if "front" in b]
    return sum(v) / len(v) if v else None
