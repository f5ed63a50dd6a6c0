"""The plain backtrack and the packed op stream, its output format.

``backtrack_antidiag`` is the plain version of ``csrc/backtrack_band.cu``
for every dirs layout: the full width of ``ops/dp.py``, the raw folded
layout of ``ops/dp_fold.py`` and the banded lane window of
``ops/dp_band.py``. ``ops/extd2.py::backtrack_band`` runs it on CPU
tensors; ``backtrack_calls`` counts its calls. ``pack_ops`` packs its ops
two bits each, as the short-read step and the long-read DP chunks ship
them to the host; ``unpack_ops`` is the host's inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from gdiet_tpu_torch.ops import LaunchCount
from gdiet_tpu_torch.ops.dp import CIGAR_DEL, CIGAR_INS, CIGAR_MATCH
from gdiet_tpu_torch.ops.dp_band import DP_UNROLL, window_base, window_geometry
from gdiet_tpu_torch.ops.dp_fold import FOLD_GAP, fold_geometry

I64 = torch.int64
I32 = torch.int32

backtrack_calls = LaunchCount()


def backtrack_antidiag(dirs, dp_lens, band, Lmax: int, tlens=None,
                       Lt: int | None = None, fold: bool = False,
                       band_budget: int | None = None, unroll: int | None = None):
    """Antidiagonal-synchronous ksw_backtrack (ksw2.h:131-163), as
    gdiet_tpu/pipeline/device_step.py:452-585. Ops stream back to front, one column per
    antidiagonal r = Rpad-1 .. 0 (R padded to a multiple of 8), 255 on idle
    columns.

    ``fold=False`` reads the dirs [N, R, Wd] of ops/dp.py, or, when
    ``band_budget``'s lane window engages at (round128(Lt), ``unroll``),
    the windowed dirs of ops/dp_band.py: lane i of wavefront r at column
    i - window_base(r // unroll * unroll). ``fold=True`` reads the raw
    folded layout of ops/dp_fold.py, [(C+1)*H, Nrows, Wd]: candidate n =
    c*Nrows + k takes wavefront r from slice c*H + r, at lane i + FOLD_GAP
    for the second half (r >= H).
    Returns (ops [N, Rpad] u8, fin_i [N] i32, fin_j [N] i32)."""
    backtrack_calls.n += 1
    dev = dirs.device
    N = dp_lens.shape[0]
    if Lt is None:
        Lt = Lmax
    if fold:
        H, Wd, T = fold_geometry(Lmax, Lt)
        Nrows = dirs.shape[1]
        R = 2 * H
        n = torch.arange(N, dtype=I64, device=dev)
        base = ((n // Nrows) * H * Nrows + n % Nrows) * Wd
        flat = dirs.reshape(-1)

        def dir_bytes(r, i):
            col = torch.clamp(i + (FOLD_GAP if r >= H else 0), 0, Wd - 1).to(I64)
            return flat[base + r * Nrows * Wd + col]
    else:
        _, R, Wd = dirs.shape
        T = -(-Lt // 128) * 128
        U_ = unroll or DP_UNROLL
        WB = (window_geometry(band_budget, T, U_)
              if band_budget is not None else None)

        def dir_bytes(r, i):
            lo = 0 if WB is None else window_base(r // U_ * U_, band_budget, T, WB)
            col = torch.clamp(i - lo, 0, Wd - 1).to(I64)
            return torch.gather(dirs[:, r, :], 1, col[:, None])[:, 0]
    BT_U = 8
    Rpad = -(-R // BT_U) * BT_U
    lens = dp_lens.to(I32)
    tl = lens if tlens is None else tlens.to(I32)
    w = band.to(I32)
    i = tl - 1
    j = lens - 1
    state = torch.zeros((N,), dtype=I32, device=dev)
    active = (lens > 0) & (tl > 0)
    ops = torch.full((N, Rpad), 255, dtype=torch.uint8, device=dev)
    # no walker starts above antidiagonal tlen+qlen-2: the columns above
    # the batch's highest start stay idle (255)
    r_top = min(R - 1, int((tl + lens - 2).max())) if N else -1
    for r in range(r_top, -1, -1):
        act = active & (i + j == r)
        st0 = torch.maximum(torch.clamp(r - lens + 1, min=0), (r - w + 1) >> 1)
        en0 = torch.minimum(torch.clamp(tl - 1, max=r), (r + w) >> 1)
        live = (st0 <= en0) & (r < lens + tl - 1) & (lens > 0)
        off_r = torch.where(live, st0 // 16 * 16, T)
        off_end_r = torch.where(live, torch.clamp((en0 + 16) // 16 * 16 - 1, max=T - 1), -1)
        force = torch.where(i > off_end_r, 1, torch.where(i < off_r, 2, -1))
        tmp = dir_bytes(r, i).to(I32)
        tmp = torch.where(force >= 0, 0, tmp)
        nstate = torch.where(state == 0, tmp & 7,
                             torch.where(((tmp >> (state + 2)) & 1) != 0, state, 0))
        nstate = torch.where(nstate == 0, tmp & 7, nstate)
        nstate = torch.where(force >= 0, force, nstate)
        op = torch.where(nstate == 0, CIGAR_MATCH,
                         torch.where((nstate == 1) | (nstate == 3), CIGAR_DEL, CIGAR_INS))
        di = ((nstate == 0) | (nstate == 1) | (nstate == 3)).to(I32)
        dj = ((nstate == 0) | (nstate == 2) | (nstate == 4)).to(I32)
        ops[:, Rpad - 1 - r] = torch.where(act, op, 255).to(torch.uint8)
        i = torch.where(act, i - di, i)
        j = torch.where(act, j - dj, j)
        state = torch.where(act, nstate, state)
        active = active & (i >= 0) & (j >= 0)
    return ops, i, j


def pack_ops(ops):
    """[N, S] op codes (0/1/2, 255 pad) -> [N, S/4] u8, 2 bits per op."""
    N, S = ops.shape
    v = torch.clamp(ops.to(I32), max=3).reshape(N, S // 4, 4)
    wts = torch.tensor([1, 4, 16, 64], dtype=I32, device=ops.device)
    return (v * wts).sum(2).to(torch.uint8)


def unpack_ops(packed: np.ndarray) -> np.ndarray:
    """Host inverse of pack_ops: [N, S/4] u8 -> [N, S] u8 with 3 = pad."""
    N, SB = packed.shape
    out = np.empty((N, SB, 4), np.uint8)
    for j in range(4):
        out[:, :, j] = (packed >> (2 * j)) & 3
    return out.reshape(N, SB * 4)
