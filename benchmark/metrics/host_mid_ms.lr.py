"""Host ms between the front's meta and the segment DP's dispatch:
candidates, round-2 accepts, segment prep (the program's lr.host_mid
spans)."""

from benchmark import spans


def read(ctx):
    return spans.total_ms("lr.host_mid")
