"""The DP's roofline: the work the extension DP and its backtrack must do
on the rows they were given, whatever kernel does it.

Per row, the band cells that ksw_extd2 defines from the row's lengths and
band (antidiagonal r spans target columns max(0, r - qlen + 1, (r - w + 1)
>> 1) .. min(tlen - 1, r, (r + w) >> 1)), up to the antidiagonal of the
row's end cell (tlen - 1, qlen - 1), where the score is read and the
backtrack starts: every exact implementation returns that cell, so every
one computes at least those cells. 57 lane operations a cell.

The peak is the packed 16x2 lane rate, 2 x SMs x 64 x the card's maximum
SM clock, so an int16 kernel cannot read above 100%. Bytes: the query and
target bytes read once, the 4-byte score and the op stream written once;
no direction bytes, an intermediate that a fused DP and backtrack would
never write. The backtrack's (fin_i, fin_j) is where its walk left the
matrix, so the walk wrote at least max(tlen - 1 - fin_i, qlen - 1 -
fin_j) ops. HBM at 3.35 TB/s (NVIDIA's H100 SXM data sheet, at the 700 W
limit). The time is the device time of every kernel launched inside the
DP and backtrack calls (``extd2_batch``, ``backtrack_band``), which the
traced run wraps in profiler ranges.
"""

from __future__ import annotations

import sys

import numpy as np

OPS_PER_CELL = 57
HBM_BYTES_PER_S = 3.35e12


def band_cells(qlen, tlen, band, r_end) -> np.ndarray:
    """Cells per row on antidiagonals 0 .. r_end of each row's band."""
    qlen, tlen, band, r_end = (np.asarray(x, np.int64) for x in (qlen, tlen, band, r_end))
    w = np.where(band < 0, np.maximum(qlen, tlen), band)
    out = np.zeros(len(qlen), np.int64)
    live = (qlen > 0) & (tlen > 0) & (r_end >= 0)
    if not live.any():
        return out
    idx = np.flatnonzero(live)
    step = max(1, (1 << 22) // int(r_end[idx].max() + 1))
    for s in range(0, len(idx), step):
        i = idx[s: s + step]
        r = np.arange(int(r_end[i].max()) + 1, dtype=np.int64)[None, :]
        q, t, ww = qlen[i, None], tlen[i, None], w[i, None]
        st = np.maximum(np.maximum(0, r - q + 1), (r - ww + 1) >> 1)
        en = np.minimum(np.minimum(t - 1, r), (r + ww) >> 1)
        n = np.where(r <= r_end[i, None], np.maximum(en - st + 1, 0), 0)
        out[i] = n.sum(1)
    return out


def work(rows) -> tuple[int, int]:
    """(lane operations, bytes) of the DP calls' rows: each entry is
    (qlens, tlens or None, band, fin_i, fin_j) as numpy arrays, as
    ``backtrack_band`` takes and returns them."""
    ops = byt = 0
    for q, t, w, fi, fj in rows:
        t = q if t is None else t
        q, t, fi, fj = (np.asarray(x, np.int64) for x in (q, t, fi, fj))
        cells = band_cells(q, t, w, q + t - 2)
        live = (q > 0) & (t > 0)
        ops += int(cells.sum()) * OPS_PER_CELL
        steps = np.maximum(t - 1 - fi, q - 1 - fj)
        byt += int((q + t + 4 + steps)[live].sum())
    return ops, byt


def packed_peak(card: dict) -> float:
    """Lane operations per second at the packed 16x2 rate."""
    return 2.0 * card["sms"] * 64 * card["max_sm_clock_mhz"] * 1e6


def share(ctx: dict):
    """Percent of the DP's roofline over the window, None without a trace
    of its kernels."""
    card = ctx.get("card")
    if (not ctx["dp_rows"] or not ctx.get("dp_device_s")
            or not card or "max_sm_clock_mhz" not in card):
        return None
    ops, byt = work(ctx["dp_rows"])
    t_ops, t_bytes = ops / packed_peak(card), byt / HBM_BYTES_PER_S
    bound = "ops" if t_ops >= t_bytes else "bytes"
    print(f"[bench] dp roofline: {ops} lane ops, {byt} bytes, bound by {bound}, "
          f"{ctx['dp_device_s']} s of DP kernels; {card}", file=sys.stderr)
    return 100.0 * max(t_ops, t_bytes) / ctx["dp_device_s"]
