"""Device front of the long-read pipeline, in torch.

Port of ``gdiet_tpu/pipeline/lr_step.py``: the shared hit collection
(``device_step.collect_hits``), the round-1 vote (GDiet-LongReads/
map.c:1052-1180), the density/relative filters and round-2 windows
(``_lr_filters_device``, map.c:1355-1445) and both round-2 window votes
(map.c:1182-1271), packed into one [B, 4 + 8K + 4 + 16] int32 meta tensor
that ``unpack_lr_meta`` reads on the host.

Both votes run through ``ops/vote.py`` on the strand halves in place:
``csrc/vote_lr.cu`` on the card (round 1, then both round-2 windows in one
launch), the plain loops beside it on the CPU.
"""

from __future__ import annotations

import torch

from gdiet_tpu_torch.ops import vote
from gdiet_tpu_torch.pipeline.device_step import StepConfig, collect_hits
from gdiet_tpu_torch.u64 import U32, srl

I64 = torch.int64
I32 = torch.int32

LR_META_B = 4  # fallback, shift, extracted, kept_len
LR_META_BK = 8  # score, fq, lq, str, chrom, ft, lt, lt_adj


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
