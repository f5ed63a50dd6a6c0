"""Device front of the long-read pipeline, in torch.

Port of ``gdiet_tpu/pipeline/lr_step.py``: the shared hit collection
(``device_step.collect_hits``), the ``vote_budget`` compaction, the
round-1 vote (``_vote_scan_lr``, GDiet-LongReads/map.c:1052-1180), the
density/relative filters and round-2 windows (``_lr_filters_device``,
map.c:1355-1445) and both round-2 window votes (``_vote2_scan``,
map.c:1182-1271), packed into one [B, 4 + 8K + 4 + 16] int32 meta tensor
that ``unpack_lr_meta`` reads on the host.

Both votes run through ``ops/vote.py``: ``csrc/vote_lr.cu`` on the card
(round 1, then both round-2 windows in one launch, reading the strand
halves in place), the plain loops below on the CPU. The plain loops walk
the concatenated fwd | barrier | rev | barrier hit stream, as the
short-read vote does; ``vote_calls`` counts their calls. Each strand's hits
sort valid-first, and a run of invalid columns acts as one (it closes the
open run and leaves nothing open), so under that precondition the loops
visit only the columns ``_stream_columns`` gives: those where some read
still has a hit plus one invalid column per strand, the same result in
fewer steps. uint64 keys are int64 bit patterns (``u64.py``).
"""

from __future__ import annotations

import torch

from gdiet_tpu_torch import u64
from gdiet_tpu_torch.ops import LaunchCount, vote
from gdiet_tpu_torch.pipeline.device_step import StepConfig, collect_hits
from gdiet_tpu_torch.u64 import U32, srl

I64 = torch.int64
I32 = torch.int32

LR_META_B = 4  # fallback, shift, extracted, kept_len
LR_META_BK = 8  # score, fq, lq, str, chrom, ft, lt, lt_adj

vote_calls = LaunchCount()


def _raw_target(t, q, sgn: int, extracted):
    """Inverse diagonal projection: the hit's raw genomic anchor
    (map.c:1064-1065), u64 wraparound."""
    qq = q.to(I64)
    return t - qq if sgn else t - (extracted - qq)


def _umin(a, b):
    return torch.where(u64.ule(a, b), a, b)


def _umax(a, b):
    return torch.where(u64.ule(a, b), b, a)


def _stream_columns(fok, rok) -> list:
    """Columns of the fwd | barrier | rev | barrier stream that the scans
    must visit: each strand's columns up to its longest valid prefix over
    the batch, plus the first column after it (an invalid hit or the
    barrier)."""
    A = fok.shape[1]
    nf = int(fok.sum(1).max()) if fok.shape[0] else 0
    nr = int(rok.sum(1).max()) if rok.shape[0] else 0
    return list(range(nf + 1)) + list(range(A + 1, A + 2 + nr))


def _vote_scan_lr(keys, qpos, valid, strand: list, extracted, vt_distance,
                  cov_thr, K: int, cols: list) -> dict:
    """Round-1 vote (lr_step.py:41-142): coverage-gated runs, raw-target
    span tracking, score-sorted top-K insertion. The plain version of
    ``csrc/vote_lr.cu``'s round 1."""
    vote_calls.n += 1
    B = keys.shape[0]
    dev = keys.device

    def z(dtype, n=None, fill=0):
        return torch.full((B,) if n is None else (B, n), fill, dtype=dtype, device=dev)

    head_valid, head_str = z(torch.bool), z(I32)
    ref_loc, first_t, last_t = z(I64), z(I64), z(I64)
    fq, lq, cnt, out_len = z(I32), z(I32), z(I32), z(I32)
    k_score = z(I32, K, -1)
    k_first_t, k_last_t = z(I64, K), z(I64, K)
    k_fq, k_lq, k_str = z(I32, K), z(I32, K), z(I32, K)
    slots = torch.arange(K, device=dev)[None, :]

    def emit(do_emit):
        nonlocal k_score, k_first_t, k_last_t, k_fq, k_lq, k_str, out_len
        # lq >= fq by construction: the i32 difference is the u32 gate
        passes = do_emit & ((lq - fq) > cov_thr)
        full = out_len == K
        insert = passes & ~(full & (k_score[:, K - 1] >= cnt))
        pos = torch.where(full, K - 1, out_len).to(I64)
        upd = insert[:, None] & (slots == pos[:, None])
        arrs = [torch.where(upd, val[:, None], arr) for arr, val in (
            (k_score, cnt), (k_first_t, first_t), (k_last_t, last_t),
            (k_fq, fq), (k_lq, lq), (k_str, head_str))]
        for kk in range(K - 1, 0, -1):
            swap = insert & (arrs[0][:, kk] > arrs[0][:, kk - 1])
            for c in arrs:
                a, b = c[:, kk - 1].clone(), c[:, kk].clone()
                c[:, kk] = torch.where(swap, a, b)
                c[:, kk - 1] = torch.where(swap, b, a)
        k_score, k_first_t, k_last_t, k_fq, k_lq, k_str = arrs
        out_len = torch.where(insert & ~full, out_len + 1, out_len)

    for m in cols:
        t, q, ok, sgn = keys[:, m], qpos[:, m], valid[:, m], strand[m]
        raw = _raw_target(t, q, sgn, extracted)
        in_run = (head_valid & ok & (head_str == sgn)
                  & u64.ule(t - ref_loc, vt_distance))
        q_lt = q < fq
        new_fq = torch.where(q_lt, q, fq)
        new_ref = torch.where(q_lt, t, ref_loc)
        new_lq = torch.maximum(lq, q)
        new_ft = _umin(first_t, raw)
        new_lt = _umax(last_t, raw)
        emit(head_valid & ~in_run)
        ref_loc = torch.where(in_run, new_ref, t)
        first_t = torch.where(in_run, new_ft, raw)
        last_t = torch.where(in_run, new_lt, raw)
        fq = torch.where(in_run, new_fq, q)
        lq = torch.where(in_run, new_lq, q)
        cnt = torch.where(in_run, cnt + 1, 1)
        head_valid = in_run | ok
        head_str = torch.where(in_run, head_str, sgn)
    emit(head_valid)
    return {"k_score": k_score, "k_first_t": k_first_t, "k_last_t": k_last_t,
            "k_fq": k_fq, "k_lq": k_lq, "k_str": k_str, "out_len": out_len}


def _vote2_scan(keys, qpos, valid, strand: list, extracted, vt_distance,
                lo, hi, cols: list) -> dict:
    """Round-2 vote (lr_step.py:146-220): the best run constrained to the
    query window (lo, hi), counting only in-window hits. The plain version
    of ``csrc/vote_lr.cu``'s round 2, one window."""
    vote_calls.n += 1
    B = keys.shape[0]
    dev = keys.device

    def z(dtype):
        return torch.zeros((B,), dtype=dtype, device=dev)

    head_valid, head_str = z(torch.bool), z(I32)
    ref_loc, first_t, last_t = z(I64), z(I64), z(I64)
    fq, lq, cnt = z(I32), z(I32), z(I32)
    best = {"b_score": z(I32), "b_first_t": z(I64), "b_last_t": z(I64),
            "b_fq": z(I32), "b_lq": z(I32), "b_str": z(I32)}

    def consider(do_emit):
        better = do_emit & (cnt > best["b_score"]) & (lq < hi) & (fq > lo)
        for name, val in (("b_score", cnt), ("b_first_t", first_t),
                          ("b_last_t", last_t), ("b_fq", fq), ("b_lq", lq),
                          ("b_str", head_str)):
            best[name] = torch.where(better, val, best[name])

    for m in cols:
        t, q, ok, sgn = keys[:, m], qpos[:, m], valid[:, m], strand[m]
        raw = _raw_target(t, q, sgn, extracted)
        in_run = (head_valid & ok & (head_str == sgn)
                  & u64.ule(t - ref_loc, vt_distance))
        in_win = in_run & (q < hi) & (q > lo)
        q_lt = in_win & (q < fq)
        consider(head_valid & ~in_run)
        ref_loc = torch.where(in_run, torch.where(q_lt, t, ref_loc), t)
        first_t = torch.where(in_run, torch.where(in_win, _umin(first_t, raw), first_t), raw)
        last_t = torch.where(in_run, torch.where(in_win, _umax(last_t, raw), last_t), raw)
        fq = torch.where(in_run, torch.where(q_lt, q, fq), q)
        lq = torch.where(in_run, torch.where(in_win, torch.maximum(lq, q), lq), q)
        cnt = torch.where(in_run, cnt + in_win.to(I32), 1)
        head_valid = in_run | ok
        head_str = torch.where(in_run, head_str, sgn)
    consider(head_valid)
    return best


def _sext(v):
    """Sign-extend the low 32 bits (the oracle's _i32)."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v)


def _lr_filters_device(vt, lens, cov_thr, k: int, vt_df1: float, vt_f: float,
                       bw: int, K: int):
    """Density filter 1, relative filter, boundary adjustment and round-2
    windows (lr_step.py:223-280): f32 products, u32 wraparound, i32 sign
    casts. Returns (kept_len [B], score, fq (u32 bits), lq, str, chrom, ft
    (i32), lt (i32 bits), lt_unsigned flag, lo1, hi1, lo2, hi2)."""
    f32, f64 = torch.float32, torch.float64
    dev = lens.device
    score = vt["k_score"].to(I64)
    fq = vt["k_fq"].to(I64)
    lq = vt["k_lq"].to(I64)
    ft_u = vt["k_first_t"] & U32
    lt_u = vt["k_last_t"] & U32
    chrom = srl(vt["k_first_t"], 32)
    out_len = vt["out_len"].to(I64)

    cidx = torch.arange(K, dtype=I64, device=dev)[None, :]
    valid0 = cidx < out_len[:, None]
    span0 = _sext(lt_u) - _sext(ft_u)
    df1 = torch.tensor(vt_df1, dtype=f32, device=dev)
    df1_pass = score.to(f32) > df1 * span0.to(f32)
    nb_df = (df1_pass & valid0).sum(1)
    valid1 = cidx < nb_df[:, None]
    thr = (score[:, 0].to(f32) * torch.tensor(vt_f, dtype=f32, device=dev)).to(I32).to(I64)
    ge = score >= thr[:, None]
    kept = valid1 & torch.cumprod(ge.to(I32), dim=1).to(torch.bool)

    fq2 = (fq - (k - 1)) & U32
    ft2 = _sext((ft_u - (k - 1)) & U32)
    dq = (lq - fq2) & U32
    span = _sext(lt_u) - ft2
    cond = dq.to(f64) + 0.5 * bw < span.to(f64)
    lt_adj = (ft2.to(f64) + dq.to(f64) + 0.5 * bw).to(I64)  # f64 truncation
    lt2 = torch.where(cond, _sext(lt_adj & U32), lt_u)

    any_kept = kept.any(1)
    # qrstart starts at qlen and only moves down (map.c:1387-1391)
    qrstart = torch.minimum(lens, torch.where(kept, fq2, 1 << 62).min(1).values)
    qrend = torch.where(kept, lq, 0).max(1).values
    cov = cov_thr.to(I64)
    win1 = any_kept & (qrstart > cov)
    win2 = any_kept & ((lens - qrend) > cov)
    lo1 = torch.zeros_like(lens).to(I32)
    hi1 = torch.where(win1, qrstart, 0).to(I32)
    lo2 = torch.where(win2, qrend, 0).to(I32)
    hi2 = torch.where(win2, lens, 0).to(I32)
    kept_len = kept.to(I64).sum(1)
    return (kept_len, score, fq2, lq, vt["k_str"].to(I64), chrom, ft2, lt2,
            cond, lo1, hi1, lo2, hi2)


def vote2_packed(keys, qv, okv, strand: list, extracted, vt_dis, lo, hi,
                 cols: list):
    """Round-2 scan with one packed [B, 8] i32 result (lr_step.py:401)."""
    vt2 = _vote2_scan(keys, qv, okv, strand, extracted, vt_dis, lo, hi, cols)
    return torch.stack([
        vt2["b_score"], vt2["b_fq"], vt2["b_lq"], vt2["b_str"],
        srl(vt2["b_first_t"], 32).to(I32), (vt2["b_first_t"] & U32).to(I32),
        srl(vt2["b_last_t"], 32).to(I32), (vt2["b_last_t"] & U32).to(I32),
    ], dim=1)


def vote2_packed_pair(keys, qv, okv, strand: list, extracted, vt_dis,
                      lo1, hi1, lo2, hi2, cols: list):
    """Both round-2 windows (head gap + tail gap, map.c:1680-1712) as one
    [B, 16] i32 block (lr_step.py:391)."""
    return torch.cat([
        vote2_packed(keys, qv, okv, strand, extracted, vt_dis, lo1, hi1, cols),
        vote2_packed(keys, qv, okv, strand, extracted, vt_dis, lo2, hi2, cols),
    ], dim=1)


def lr_front(codes, lens, tables: dict, cov_thr, vt_dis, cfg: StepConfig,
             k: int, vt_df1: float, vt_f: float, bw: int) -> torch.Tensor:
    """Device front of the LR mm_map_frag (lr_step.py:283-362): hit
    collection, round-1 vote, filters and both round-2 window votes.
    codes [B, Lmax] u8, lens [B] i64, cov_thr [B] i32, vt_dis [B] i64 (u64
    bits); ``tables`` as ``collect_hits`` takes them (the whole index, or
    one data row's shards of ``parallel.dist.sharded_lr_front``, whose
    merged streams are A * n_ref wide). Returns the packed meta [B, 4 + 8K
    + 4 + 16] i32."""
    (fallback, shift, extracted, _mv_n, _capped,
     fk, fq, fok, rk, rq, rok) = collect_hits(codes, lens, tables, cfg)
    # compact the voted stream: the strand-sorted hits put valid ones first,
    # so the scans run over vote_budget slots (views, not copies);
    # overflowing reads fall back
    C = cfg.vote_budget
    if C and C < fk.shape[1]:
        fallback = (fallback | (fok.sum(1, dtype=I32) > C)
                    | (rok.sum(1, dtype=I32) > C))
        fk, fq, fok = fk[:, :C], fq[:, :C], fok[:, :C]
        rk, rq, rok = rk[:, :C], rq[:, :C], rok[:, :C]
    # the halves are read in place (valid-first, as ops/vote.py requires)
    halves = (fk, fq, fok, rk, rq, rok)
    vt = vote.vote_lr(*halves, extracted, vt_dis, cov_thr, cfg.K)
    (kept_len, score, fq2, lq, strv, chrom, ft2, lt2, ltadj,
     lo1, hi1, lo2, hi2) = _lr_filters_device(
        vt, lens.to(I64), cov_thr, k, vt_df1, vt_f, bw, cfg.K)
    vt2p = vote.vote2_pair(*halves, extracted, vt_dis, lo1, hi1, lo2, hi2)
    return torch.cat([
        fallback.to(I32)[:, None], shift.to(I32)[:, None],
        extracted.to(I32)[:, None], kept_len.to(I32)[:, None],
        score.to(I32), fq2.to(I32), lq.to(I32), strv.to(I32), chrom.to(I32),
        ft2.to(I32), lt2.to(I32), ltadj.to(I32),
        lo1[:, None], hi1[:, None], lo2[:, None], hi2[:, None], vt2p,
    ], dim=1)


def unpack_lr_meta(meta, K: int) -> dict:
    """Host inverse of lr_front's packed meta (lr_step.py:369-388)."""
    out = {
        "fallback": meta[:, 0].astype(bool),
        "shift": meta[:, 1],
        "extracted": meta[:, 2],
        "kept_len": meta[:, 3],
    }
    base = LR_META_B
    names = ("k_score", "k_fq", "k_lq", "k_str", "k_chrom", "k_ft", "k_lt",
             "k_lt_adj")
    for f, name in enumerate(names):
        out[name] = meta[:, base + f * K: base + (f + 1) * K]
    base += len(names) * K
    for j, name in enumerate(("lo1", "hi1", "lo2", "hi2")):
        out[name] = meta[:, base + j]
    out["vt2"] = meta[:, base + 4: base + 20]
    return out
