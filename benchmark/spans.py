"""The program's own spans of the window, for the per-layer readers.

``gdiet_tpu_torch/utils/profile.py::PROFILE`` keeps every span as an
interval while a ``torch.profiler`` collects, as it does over a traced
window; ``runtime.run_generic`` is the root span ``run``. The readers take
the spans under the last ``run`` root. Their clock is the profiler's
(Unix-epoch ns), so they intersect with ``ctx["events"]`` (us) directly.
Where the program kept no such root (an untraced run, or a program without
the recorder) every reader returns None.
"""


def window_spans():
    """(root, spans below it) of the last ``run``, or None."""
    from gdiet_tpu_torch.utils import profile

    tree = getattr(profile.PROFILE, "tree", None)
    return tree("run") if tree is not None else None


def total_ms(*names):
    """Summed ms of the window's spans called any of ``names``; None
    without a ``run`` root."""
    t = window_spans()
    if t is None:
        return None
    return sum(s.end - s.start for s in t[1] if s.name in names) / 1e6


def union_s(intervals) -> float:
    """Seconds covered by (start s, end s) intervals, overlaps once."""
    out, hi = 0.0, float("-inf")
    for a, b in sorted(intervals):
        a = max(a, hi)
        if b > a:
            out += b - a
            hi = b
    return out
