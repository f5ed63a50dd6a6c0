"""Batched sketching: k-mer hashing + windowed-min minimizers, in torch.

Port of ``gdiet_tpu/ops/sketch.py`` (see its docstring for the emission-time
derivation that reproduces the reference's ring-buffer scan,
GDiet-ShortReads/sketch.c:1577-2225). Hashes and packed positions are uint64
bit patterns in int64 (``gdiet_tpu_torch/u64.py``); every order comparison
and window minimum runs on ``u64.ordered`` values, where ``U64_MAX`` is the
largest.
"""

from __future__ import annotations

import torch

from gdiet_tpu_torch import u64
from gdiet_tpu_torch.u64 import ORD_MAX, ORD_MIN, U64_MAX, srl


def hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    """Invertible mix hash (sketch.c:25-34) on uint64 bit patterns."""
    key = (~key + (key << 21)) & mask
    key = key ^ srl(key, 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ srl(key, 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ srl(key, 28)
    key = (key + (key << 31)) & mask
    return key


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[..., i] -> x[..., i-d] with ``fill`` in the first d slots."""
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _shift_left(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., d:], pad], dim=-1)


def trailing_window_min(x: torch.Tensor, w: int, fill) -> torch.Tensor:
    """min over x[..., i-w+1 : i+1] via log2(w) doubling steps (signed)."""
    f = x
    span = 1
    while span * 2 <= w:
        f = torch.minimum(f, _shift_right(f, span, fill))
        span *= 2
    if span < w:
        f = torch.minimum(f, _shift_right(f, w - span, fill))
    return f


def leading_window_min(x: torch.Tensor, w: int, fill) -> torch.Tensor:
    """min over x[..., i : i+w] (signed)."""
    f = x
    span = 1
    while span * 2 <= w:
        f = torch.minimum(f, _shift_left(f, span, fill))
        span *= 2
    if span < w:
        f = torch.minimum(f, _shift_left(f, w - span, fill))
    return f


def kmer_scan(diet_codes, diet_valid, real_pos, rid, k: int, w: int) -> dict:
    """Per-position canonical k-mer keys x, packed positions y, run lengths
    l and the emitted-minimizer mask, all [B, D] (ops/sketch.py:107-206).
    Invalid positions hold ``U64_MAX`` in x and y."""
    B, D = diet_codes.shape
    dev = diet_codes.device
    codes = diet_codes.to(torch.int64)
    is_base = (diet_codes < 4) & diet_valid
    mask = (1 << (2 * k)) - 1

    # k-mer construction by binary doubling (ops/sketch.py:128-168)
    segs = {1: codes & 3}
    segs_r = {1: (3 ^ codes) & 3}
    l_ = 1
    while l_ * 2 <= k:
        segs[l_ * 2] = (_shift_right(segs[l_], l_, 0) << (2 * l_)) | segs[l_]
        segs_r[l_ * 2] = (segs_r[l_] << (2 * l_)) | _shift_right(segs_r[l_], l_, 0)
        l_ *= 2
    kf = kr = None
    done = 0
    bit = 1
    while bit <= k:
        if k & bit:
            if kf is None:
                kf, kr = segs[bit], segs_r[bit]
                done = bit
            else:
                kf = (_shift_right(kf, bit, 0) << (2 * bit)) | segs[bit]
                kr = (segs_r[bit] << (2 * done)) | _shift_right(kr, bit, 0)
                done += bit
        bit <<= 1
    kf = kf & mask
    kr = kr & mask

    idx = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    last_bad = torch.where(is_base, torch.full_like(codes, -1), idx.expand(B, D))
    last_bad = torch.cummax(last_bad, dim=-1).values
    run_start = last_bad + 1
    l = torch.where(is_base, idx - run_start + 1, torch.zeros_like(codes))

    # kf/kr are masked to 2k < 63 bits, so signed and unsigned order agree
    strand = (kf >= kr).to(torch.int64)  # z = 0 iff kmer_f < kmer_r
    symmetric = kf == kr
    kmin = torch.where(strand == 0, kf, kr)
    x = (hash64(kmin, mask) << 8) | k
    pos_u32 = (real_pos.to(torch.int64) << 1) & u64.U32
    y = (rid.to(torch.int64)[:, None] << 32) | pos_u32 | strand

    kmer_ok = is_base & (l >= k) & ~symmetric
    x = torch.where(kmer_ok, x, torch.full_like(x, U64_MAX))
    y = torch.where(kmer_ok, y, torch.full_like(y, U64_MAX))

    full_window = is_base & (l >= w + k - 1)
    xo = u64.ordered(x)
    m = trailing_window_min(xo, w, ORD_MAX)
    # p is emitted iff the MAX over the minima of the full windows holding
    # it equals x_p; non-full windows get the sentinel 0 (ORD_MIN ordered).
    # max via min on complements: ~ reverses the signed order too
    m_masked = torch.where(full_window, m, torch.full_like(m, ORD_MIN))
    M = ~leading_window_min(~m_masked, w, ORD_MAX)
    emitted = (x != U64_MAX) & (xo == M)
    return {
        "x": x, "xo": xo, "y": y, "l": l, "run_start": run_start,
        "is_base": is_base, "emitted": emitted,
    }


def sketch_emit(diet_codes, diet_len, real_pos, rid, k: int, w: int,
                max_out: int, final_flush_ge: bool = True):
    """Minimizers in scalar emission order, packed [B, max_out].

    Returns (xs, ys, valid_mask, counts) like ops/sketch.py::sketch_emit."""
    return _emit_core(diet_codes, diet_len, real_pos, rid, k, w, max_out,
                      final_flush_ge)


def sketch_emit_build(diet_codes, diet_len, lo, rid, k: int, w: int,
                      max_out: int, ones_loc: tuple, plen: int,
                      final_flush_ge: bool = True):
    """Index-build variant: real coordinates derived from the diet pattern
    at shift 0 (ops/sketch.py:235-281, ``packed=False``). Returns
    (xy [B, 2*max_out] with xs then ys, counts)."""
    B, D = diet_codes.shape
    dev = diet_codes.device
    j = lo.to(torch.int64)[:, None] + torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    loc = torch.tensor(ones_loc, dtype=torch.int64, device=dev)
    ones = len(ones_loc)
    real_pos = (j // ones) * plen + loc[j % ones]
    xs, ys, _, nvalid = _emit_core(diet_codes, diet_len, real_pos, rid, k, w,
                                   max_out, final_flush_ge)
    return torch.cat([xs, ys], dim=1), nvalid


def _emit_core(diet_codes, diet_len, real_pos, rid, k, w, max_out,
               final_flush_ge):
    B, D = diet_codes.shape
    dev = diet_codes.device
    idx = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    dlen = diet_len.to(torch.int64)[:, None]
    diet_valid = idx < dlen

    res = kmer_scan(diet_codes, diet_valid, real_pos, rid, k, w)
    x, xo, l, emitted = res["x"], res["xo"], res["l"], res["emitted"]
    INF_T = 2 * D + 4
    inf_t = torch.full((B, D), INF_T, dtype=torch.int64, device=dev)
    idx_b = idx.expand(B, D)

    # exposure E(p): exit time of the newest smaller predecessor in window
    E = idx_b
    for d in range(1, w):
        smaller = _shift_right(xo, d, ORD_MAX) < xo
        E = torch.where(smaller & (E == idx), idx + (w - d), E)

    # first equal / first <= successor within (p, p+w)
    valid_x = x != U64_MAX
    d_eq = inf_t
    d_le = inf_t
    for d in range(1, w):
        xs_ = _shift_left(xo, d, ORD_MAX)
        eq = (xs_ == xo) & valid_x
        le = (xs_ <= xo) & valid_x
        d_eq = torch.where(eq & (d_eq == INF_T), torch.full_like(d_eq, d), d_eq)
        d_le = torch.where(le & (d_le == INF_T), torch.full_like(d_le, d), d_le)

    ff = res["run_start"] + (w + k - 2)

    # first invalid position strictly after p (ambiguous-base flush)
    invalid = ~res["is_base"] & diet_valid
    inv_idx = torch.where(invalid, idx_b, inf_t)
    rev_min = torch.flip(torch.cummin(torch.flip(inv_idx, [-1]), dim=-1).values, [-1])
    t_nf = _shift_left(rev_min, 1, INF_T)

    t_disp = torch.where(d_le != INF_T, torch.maximum(idx + d_le, ff), inf_t)
    t_exit = torch.where(idx + w < dlen, idx_b + w, inf_t)
    t_final = dlen.expand(B, D)
    t_caseB = torch.minimum(torch.minimum(t_disp, t_exit), torch.minimum(t_nf, t_final))
    caseA = (d_eq != INF_T) & (idx + d_eq <= E)
    t = torch.where(caseA, torch.maximum(E, ff), t_caseB)

    if not final_flush_ge:
        # mm_sketch: final flush requires l > w+k-1
        last = torch.clamp(dlen - 1, 0, D - 1)
        l_last = torch.gather(l, 1, last)
        drop = (t == dlen) & (l_last == w + k - 1)
        emitted = emitted & ~drop

    # stable order by (emission time, position) in one i32 key
    key = torch.where(emitted, t * (D + 1) + idx, torch.full_like(t, 0x7FFFFFFF))
    perm = torch.sort(key.to(torch.int32), dim=1, stable=True).indices[:, :max_out]
    xs = torch.gather(x, 1, perm)
    ys = torch.gather(res["y"], 1, perm)
    nvalid = emitted.sum(dim=-1)
    valid = torch.arange(max_out, dtype=torch.int64, device=dev)[None, :] < nvalid[:, None]
    return xs, ys, valid, nvalid
