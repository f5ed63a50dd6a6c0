"""The fused short-read mapping step, in torch.

Port of ``gdiet_tpu/pipeline/device_step.py`` (see its docstring for the
stages of mm_map_frag, GDiet-ShortReads/map.c:586-1010): shift inference
+ query sketch (merged for an absolute ``-i``, in two phases for a
fractional one), cuckoo seed lookup, mm_seed_select, query-occ check, hit
expansion and per-strand sort, run vote, window geometry and gathers,
exact/substitution-only shortcuts, DP-row compaction, banded DP and
antidiagonal backtrack (``ops/extd2.py``: the CUDA kernels on the card, the
plain versions on the CPU; folded when ``StepConfig.dp_fold``) and output
packing. The outputs — meta [B, 3+12K] int32 and 2-bit packed ops — are
byte-identical to ``fused_map_step``'s, so ``native.sr_finish_batch`` and
``native.pe_finish_batch`` consume them unchanged.

``TorchFusedMapper(dp_fold=True)`` (``GDIET_DP_FOLD=1`` at the entry
point, ``runtime.py``) folds the DP where the banded lane window cannot
engage, the JAX step's condition, resolved once per mapper.
Unlike the JAX step, which never folds off the TPU, the port folds on the
CPU too, through the plain fold version. ``extd2.route_state_dtype`` picks
the DP's lane state (int16 or int32; the outputs are bit-equal either way).

uint64 values are int64 bit patterns (``gdiet_tpu_torch/u64.py``). TPU
gather workarounds (one-hot matmul selects, chunk-row window gathers) are
plain gathers here, with indices clamped explicitly where JAX clamps
silently. The vote scan runs through ``ops/vote.py``: ``csrc/vote_scan.cu``
on the card (reading the strand halves in place), the plain loop
``vote_scan`` below on the CPU (over their concatenation).

``backtrack_antidiag`` is the plain version of ``csrc/backtrack_band.cu``
for every dirs layout: full width and folded (this step) and the banded
window of the long-read buckets (``ops/dp_band.py``). ``collect_hits`` is
the long-read front's too (``pipeline/lr_step.py``).

Under a mesh (``parallel/dist.py``) the step runs once per data row with
that row's key-range shards of the index in ``tables["shards"]``:
``collect_hits`` probes every shard with ``bisect_lookup`` (the
single-device mappers keep the cuckoo probe), sums the counts and merges
the shards' hit streams (``merge_hits``), the ``ref_axis`` branch of
``gdiet_tpu``'s step. ``upto`` cuts the step at the stage boundaries of
the five-stage profile (``staged_times``, ``-v 4``).

Not ported (ROADMAP): ``fuse_out_device``, a TPU-link transfer trick.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace as dataclass_replace

import numpy as np
import torch

from gdiet_tpu_torch import config, pattern, u64
from gdiet_tpu_torch.ops import LaunchCount, extd2, vote
from gdiet_tpu_torch.ops.dp import CIGAR_DEL, CIGAR_INS, CIGAR_MATCH
from gdiet_tpu_torch.ops.dp_band import DP_UNROLL, window_base, window_geometry
from gdiet_tpu_torch.ops.dp_fold import FOLD_GAP, fold_geometry
from gdiet_tpu_torch.ops.sketch import sketch_emit
from gdiet_tpu_torch.u64 import ORD_MAX, U32, U64_MAX, srl

I64 = torch.int64
I32 = torch.int32

backtrack_calls = LaunchCount()
vote_calls = LaunchCount()


@dataclass(frozen=True)
class StepConfig:
    """Static configuration of the fused step (device_step.py:243-302)."""

    k: int
    w: int
    pattern: str
    Lmax: int
    S: int
    S2: int
    A: int
    K: int
    max_nb_seeds: int
    frac_mode: bool
    max_seeds: float
    min_cnt: float
    rec_frac: float
    bw_min: int
    bw_max: int
    bw_frac: float
    occ_dist: int
    max_max_occ: int
    q_occ_on: bool
    q_occ_frac: float
    mid_occ: int
    match_a: int
    params: tuple
    frag_mode: bool
    cuckoo_c1: int = 0
    cuckoo_c2: int = 0
    cuckoo_nb: int = 0
    dp_frac: float = 1.0
    dp_fold: bool = False  # folded DP layout (TorchFusedMapper resolves it)
    vote_budget: int = 0  # >0: the LR front compacts the vote stream to it
    # the front drops the query's over-repeated minimizers itself (the LR
    # mapper); else such a read falls back (the short-read step, held
    # bit-equal to gdiet_tpu's)
    q_occ_drop: bool = False
    # "cuckoo": the merged-row cuckoo table of the whole index (the
    # single-device mappers); "bisect": a bucketed binary search over one
    # key-range shard (the sharded paths, parallel/dist.py sets it)
    probe: str = "cuckoo"
    bucket_shift: int = 0  # the shard bucket of a key: its top bits
    bucket_iters: int = 30  # binary-search depth within a bucket

    @classmethod
    def from_options(cls, mi, mo, mid_occ: int, Lmax: int, S: int, S2: int,
                     A: int) -> "StepConfig":
        frag = bool(mo.flag & config.MM_F_FRAG_MODE)
        max_nb = (800 if mo.max_frag_len == 0 else mo.max_frag_len) if frag else U32
        return cls(
            k=mi.k, w=mi.w, pattern=mo.pattern, Lmax=Lmax, S=S, S2=S2, A=A,
            K=mo.AF_max_loc, max_nb_seeds=max_nb, frac_mode=mo.max_seeds < 1,
            max_seeds=mo.max_seeds, min_cnt=mo.min_cnt,
            rec_frac=mo.rec_threshold_frac, bw_min=mo.bw_min,
            bw_max=mo.bw_max, bw_frac=mo.bw_frac, occ_dist=mo.occ_dist,
            max_max_occ=mo.max_max_occ, q_occ_on=mo.q_occ_frac > 0,
            q_occ_frac=mo.q_occ_frac, mid_occ=mid_occ, match_a=mo.a,
            params=(mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2), frag_mode=frag,
        )


def dp_rows(N: int, dp_frac: float) -> int:
    """Static DP/backtrack row budget for an N-slot candidate set."""
    return min(N, max(128, -(-int(N * dp_frac) // 128) * 128))


def _max_safe_subs(params) -> int:
    """Largest diagonal-mismatch count with a provably all-M alignment
    (device_step.py:310-325)."""
    a, b, q, e, q2, e2 = params
    g = 1
    while g < 64 and b * g < 2 * min(q + e * g, q2 + e2 * g):
        g += 1
    return g - 1


def _pattern_tables(cfg: StepConfig):
    """Per-shift gather maps [W, Dmax] + prefix-ones table [W+1]."""
    maps = [pattern.gather_map(cfg.Lmax, cfg.pattern, s) for s in range(len(cfg.pattern))]
    Dmax = max(len(m) for m in maps)
    W = len(cfg.pattern)
    arr = np.full((W, Dmax), cfg.Lmax - 1, np.int64)
    for s, m in enumerate(maps):
        arr[s, : len(m)] = m
    pref = np.zeros(W + 1, np.int64)
    for i, c in enumerate(cfg.pattern):
        pref[i + 1] = pref[i] + (c == "1")
    return arr, pref, Dmax


def _diet_len(lens, shift: int, pref, W: int):
    """diet_length (sketch.c:1942-1948): [B] int64."""
    eff = torch.clamp(lens - shift, min=0)
    return (eff // W) * pref[W] + pref[eff % W]


def _to_i32(v):
    v = v & U32
    return torch.where(v >= (1 << 31), v - (1 << 32), v)


def _cummax(x, dim=1):
    return torch.cummax(x, dim=dim).values


# ---------------------------------------------------------------------------
# the collectives of a mesh's ref axis (parallel/dist.py)
# ---------------------------------------------------------------------------
def psum_ref(xs: list, device) -> torch.Tensor:
    """The ref shards' tensors summed on ``device`` (a data row's lead)."""
    out = xs[0].to(device)
    for x in xs[1:]:
        out = out + x.to(device)
    return out


def all_gather_ref(xs: list, device) -> torch.Tensor:
    """The ref shards' [B, n] tensors concatenated along dim 1 in ref
    order, on ``device``."""
    return torch.cat([x.to(device) for x in xs], dim=1)


# ---------------------------------------------------------------------------
# phases 1-3: sketch, lookup, seed selection, hit expansion
# ---------------------------------------------------------------------------
def cuckoo_lookup(q, table, cfg: StepConfig):
    """mm_idx_get (index.c:84-100) as a two-sided bucketed cuckoo probe:
    each side gathers its bucket's 8 words (k0..k3, v0..v3), the keys as
    the table holds them, mixed (``u64.fmix64``; ``index/cuckoo.py``).
    Returns (start, count) int64, 0 where the key is absent."""
    NB = cfg.cuckoo_nb
    slots = torch.arange(8, dtype=I64, device=q.device)
    v = torch.zeros_like(q)
    found = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    h = u64.fmix64(q)
    for b in (u64.range_map(h, cfg.cuckoo_c1, NB),
              u64.range_map(h, cfg.cuckoo_c2, NB) + NB):
        ent = table[b[..., None] * 8 + slots]
        m = ent[..., :4] == h[..., None]
        # keys are unique: at most one slot of both sides matches
        v = v + torch.where(m, ent[..., 4:], 0).sum(-1)
        found = found | m.any(-1)
    s = srl(v, 24)
    c = v & 0xFFFFFF
    return torch.where(found, s, 0), torch.where(found, c, 0)


def bisect_lookup(q, shard: dict, cfg: StepConfig):
    """mm_idx_get as a bucketed binary search over one key-range shard
    (device_step.py:838-860): the bucket of ``q``'s top bits bounds the
    search, then ``cfg.bucket_iters`` halvings. ``shard`` holds the sorted
    ``keys`` (padded with U64_MAX), their packed ``vals`` (start << 24 |
    count) and the ``buckets`` table; keys compare unsigned. Returns
    (start, count) int64, 0 where the key is absent."""
    keys, vals, buckets = shard["keys"], shard["vals"], shard["buckets"]
    nk = keys.shape[0]
    if nk == 0:
        return torch.zeros_like(q), torch.zeros_like(q)
    nb = buckets.shape[0] - 1
    j = torch.clamp(srl(q, cfg.bucket_shift), 0, max(nb - 1, 0))
    lo, hi = buckets[j], buckets[j + 1]
    qo = u64.ordered(q)
    for _ in range(cfg.bucket_iters):
        mid = (lo + hi) >> 1
        km = u64.ordered(keys[torch.clamp(mid, 0, nk - 1)])
        open_ = lo < hi
        go_r = open_ & (km < qo)
        lo = torch.where(go_r, mid + 1, lo)
        hi = torch.where(open_ & ~go_r, mid, hi)
    at = torch.clamp(lo, 0, nk - 1)
    found = (lo < nk) & (keys[at] == q)
    v = vals[at]
    return torch.where(found, srl(v, 24), 0), torch.where(found, v & 0xFFFFFF, 0)


def _seed_select(cnts, qpos, seed_ok, lens, cfg: StepConfig):
    """mm_seed_select (seed.c:66-106) exactly, as sorts + scans
    (device_step.py:703-768). Returns the kept mask [B, S]."""
    B, S = cnts.shape
    dev = cnts.device
    present = seed_ok & (cnts > 0)
    low = present & (cnts <= cfg.mid_occ)
    high = present & ~low
    n_present = present.sum(1)
    idx = torch.arange(S, dtype=I64, device=dev)[None, :].expand(B, S)
    q64 = qpos.to(I64)

    BIGP = 1 << 62
    lowkey = (idx << 32) | q64
    ps_pack = _cummax(torch.where(low, lowkey, -1))
    ps = torch.where(ps_pack >= 0, ps_pack & U32, 0)
    pe_pack = torch.flip(torch.cummin(torch.flip(
        torch.where(low, lowkey, BIGP), [1]), dim=1).values, [1])
    pe = torch.where(pe_pack < BIGP, pe_pack & U32, lens[:, None])

    H = ((pe - ps).to(torch.float64) / cfg.occ_dist + 0.499).to(I64)
    H = torch.clamp(H, max=128)  # MAX_MAX_HIGH_OCC

    sid = torch.cumsum(low.to(I64), dim=1)
    BIG = 1 << 62
    nq = torch.clamp(cnts.to(I64), max=0xFFFFFF)
    key = torch.where(high, (sid << 40) | (nq << 16) | idx, BIG)
    perm = torch.sort(key, dim=1, stable=True).indices
    key_s = torch.gather(key, 1, perm)
    H_s = torch.gather(H, 1, perm)
    grp = key_s >> 40
    is_start = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                          grp[:, 1:] != grp[:, :-1]], dim=1)
    start_idx = _cummax(torch.where(is_start, idx, -1))
    rank = idx - start_idx
    sel_sorted = (key_s < BIG) & (rank < H_s)
    selected = torch.zeros_like(sel_sorted).scatter(1, perm, sel_sorted)

    kept = present & (low | (selected & (cnts <= cfg.max_max_occ)))
    return torch.where((n_present <= 1)[:, None], present, kept)


def _expand_hits(starts, counts, qpos, qstrand, positions, extracted, A: int):
    """Flatten ragged per-seed hit lists to [B, A], project to diagonal
    keys (map.c:294-311) and sort each strand (device_step.py:173-240)."""
    B, S = starts.shape
    dev = starts.device
    cum = torch.cumsum(counts, dim=1)
    total = cum[:, -1]
    a_idx = torch.arange(A, dtype=I64, device=dev)[None, :]
    # owning seed per hit slot: #{s : cum[s] <= a}
    sid = torch.searchsorted(cum, a_idx.expand(B, A).contiguous(), right=True)
    sid_c = torch.clamp(sid, 0, S - 1)
    prev_tbl = torch.cat([torch.zeros((B, 1), dtype=I64, device=dev), cum[:, :-1]], 1)
    off_in = a_idx - torch.gather(prev_tbl, 1, sid_c)
    pidx = torch.gather(starts, 1, sid_c) + off_in
    hit = positions[torch.clamp(pidx, 0, positions.shape[0] - 1)]
    ok = a_idx < total[:, None]

    qp = torch.gather(qpos, 1, sid_c)
    qs = torch.gather(qstrand, 1, sid_c)
    strand = (hit & 1).to(I32) ^ qs
    loc = (hit & U32) >> 1
    chrom = srl(hit, 32)
    qp64 = qp.to(I64)
    proj_f = (loc + extracted[:, None].to(I64) - qp64) & U32
    proj_r = (loc + qp64) & U32
    out = []
    for sgn, proj in ((0, proj_f), (1, proj_r)):
        val = ok & (strand == sgn)
        key = torch.where(val, (chrom << 32) | proj, U64_MAX)
        perm = u64.argsort_u64(key, dim=1)
        out += [torch.gather(key, 1, perm), torch.gather(qp, 1, perm),
                torch.gather(val, 1, perm)]
    return (*out, total)


def collect_hits(codes, lens, tables: dict, cfg: StepConfig, upto: str | None = None):
    """Device front of mm_map_frag (phases 1-3, device_step.py:771-1043):
    the merged shift/sketch branch for an absolute ``-i``, shift inference
    then the query sketch for a fractional one.

    ``tables["shards"]``, where present, holds the key-range shards of a
    sharded index (``parallel/dist.py``), one dict per ref device: each
    probe runs on every shard on its own device, the global occurrence
    counts are their ``psum_ref`` on ``codes``' device, each shard expands
    its own hits against its own positions and the strand streams are
    merged (``all_gather_ref`` in ref order, then a stable sort by key) to
    A * n_ref columns. Without it ``tables`` is the one whole index.

    Returns (fallback, shift, extracted, mv_n, capped, fk, fq, fok, rk, rq,
    rok); ``upto="pattern"`` (the five-stage profile's first cut) returns
    (fallback, shift) after the shift inference."""
    B = codes.shape[0]
    dev = codes.device
    W = len(cfg.pattern)
    k, w = cfg.k, cfg.w
    maps, pref = tables["maps"], tables["pref"]
    shards = tables.get("shards") or [tables]
    rid0 = torch.zeros((B,), dtype=I64, device=dev)
    Dmax = maps.shape[1]
    fallback = torch.zeros((B,), dtype=torch.bool, device=dev)

    def probe(q):
        """(start, local count) per shard, each on its shard's device."""
        out = []
        for sh in shards:
            qs = q.to(sh["positions"].device)
            out.append(cuckoo_lookup(qs, sh["cuckoo"], cfg) if cfg.probe == "cuckoo"
                       else bisect_lookup(qs, sh, cfg))
        return out

    def counts(q):
        """Global occurrence counts, on ``codes``' device."""
        return psum_ref([c for _, c in probe(q)], dev)

    def sketch_shift(s: int, dlen, cap: int):
        return sketch_emit(codes[:, maps[s]], dlen, maps[s].expand(B, Dmax), rid0,
                           k, w, cap, final_flush_ge=True)

    if not cfg.frac_mode:
        # ---- phases 1+2 merged: sketch each shift once at the full
        # budget, probe only the first -i seeds' counts for the shift
        # argmax ----
        cap_int = int(cfg.max_seeds)
        unlimited = cap_int == 0  # a cap of 0 means "no cap" (sketch.c push loop)
        cap_cols = cfg.S if cap_int <= 0 else min(cfg.S, cap_int)
        per_shift, effs = [], []
        for s in range(W):
            xs_s, ys_s, _, n_s = sketch_shift(s, _diet_len(lens, s, pref, W), cfg.S)
            eff = n_s if unlimited else torch.clamp(n_s, max=cap_int)
            if unlimited or cap_int > cfg.S:
                fallback = fallback | (n_s >= cfg.S)
            effs.append(eff)
            per_shift.append((xs_s, ys_s, n_s))
        qcat = srl(torch.cat([t[0][:, :cap_cols] for t in per_shift], dim=1), 8)
        cnt_cat = counts(qcat)
        col = torch.arange(cap_cols, dtype=I64, device=dev)[None, :]
        nb_hits = torch.stack([
            (cnt_cat[:, s * cap_cols:(s + 1) * cap_cols] * (col < effs[s][:, None])).sum(1)
            for s in range(W)])
        shift = torch.argmax(nb_hits, dim=0)  # first maximal index on ties

        def _sel(field):
            out = per_shift[0][field]
            for s in range(1, W):
                c = shift == s
                out = torch.where(c[:, None] if out.dim() == 2 else c,
                                  per_shift[s][field], out)
            return out

        xs, ys, n3 = _sel(0), _sel(1), _sel(2)
    else:
        # ---- phase 1: shift inference (mm_sketch2 + mm_get_shift) on the
        # cropped shift-0 scan, whose seed count caps the other shifts ----
        len_crop0 = (lens.to(torch.float64) * cfg.max_seeds).to(I64)
        col = torch.arange(cfg.S2, dtype=I64, device=dev)[None, :]
        nb_hits = []
        cap_vec = None
        for s in range(W):
            xs_s, _, _, n = sketch_shift(
                s, _diet_len(len_crop0 if s == 0 else lens, s, pref, W), cfg.S2)
            if s == 0:
                cap_vec = eff = n  # sketch.c:2219-2222
                over = n >= cfg.S2
            else:
                # the push loop stops only when the count EQUALS the cap,
                # so a cap of 0 never fires and means "no cap"
                unlimited = cap_vec == 0
                eff = torch.where(unlimited, n, torch.minimum(n, cap_vec))
                over = (n >= cfg.S2) & (unlimited | (cap_vec > cfg.S2))
            fallback = fallback | over
            cnts = counts(srl(xs_s, 8))
            nb_hits.append((cnts * (col < eff[:, None])).sum(1))
        shift = torch.argmax(torch.stack(nb_hits), dim=0)

        # ---- phase 2: query sketch (mm_sketch3) at the chosen shift ----
        rp3 = maps[shift]
        xs, ys, _, n3 = sketch_emit(
            torch.gather(codes, 1, rp3), _diet_len(lens, shift, pref, W), rp3,
            rid0, k, w, cfg.S, final_flush_ge=True)
    if cfg.S < cfg.max_nb_seeds:
        fallback = fallback | (n3 > cfg.S)
    if upto == "pattern":
        return fallback, shift

    cap_col = min(cfg.max_nb_seeds, cfg.S) - 1
    capped = n3 >= cfg.max_nb_seeds
    extracted = torch.where(capped, (ys[:, cap_col] & U32) >> 1, lens)
    mv_n = torch.clamp(n3, max=cfg.max_nb_seeds)
    pos = torch.arange(cfg.S, dtype=I64, device=dev)[None, :]
    seed_ok = pos < torch.clamp(mv_n, max=cfg.S)[:, None]
    if cfg.q_occ_on:
        # mm_seed_mz_flt (seed.c:5-29): a minimizer whose occurrences in the
        # query exceed both mid_occ and n * q_occ_frac is dropped. With
        # q_occ_drop the front drops it and the others move up in their
        # order; else the read falls back, as gdiet_tpu's step does
        xs_sorted, order = torch.sort(u64.ordered(torch.where(seed_ok, xs, U64_MAX)),
                                      dim=1, stable=True)
        new_run = xs_sorted[:, 1:] != xs_sorted[:, :-1]
        one = torch.ones((B, 1), dtype=torch.bool, device=dev)
        run_start = _cummax(torch.where(torch.cat([one, new_run], dim=1), pos, -1))
        run_end = torch.cummin(torch.where(torch.cat([new_run, one], dim=1), pos, cfg.S)
                               .flip(1), dim=1).values.flip(1)
        run = run_end - run_start + 1
        over = ((xs_sorted != ORD_MAX) & (run > cfg.mid_occ)
                & (run.to(torch.float64) > mv_n.to(torch.float64)[:, None] * cfg.q_occ_frac))
        if cfg.q_occ_drop:
            drop = torch.zeros_like(seed_ok).scatter(1, order, over)
            keep_first = torch.argsort(drop.to(I32), dim=1, stable=True)
            xs, ys = torch.gather(xs, 1, keep_first), torch.gather(ys, 1, keep_first)
            mv_n = mv_n - drop.sum(1)
            seed_ok = pos < torch.clamp(mv_n, max=cfg.S)[:, None]
        else:
            fallback = fallback | over.any(1)

    # ---- phase 3: seed lookup + hit expansion ----
    looked = probe(torch.where(seed_ok, srl(xs, 8), U64_MAX))
    cnts = psum_ref([c for _, c in looked], dev)
    qpos = ((ys & U32) >> 1).to(I32)
    if cfg.occ_dist > 0 and cfg.max_max_occ > cfg.mid_occ:
        kept = _seed_select(cnts, qpos, seed_ok, lens, cfg)
    else:
        kept = seed_ok & (cnts > 0) & (cnts <= cfg.mid_occ)
    # the budget test takes the global counts; each shard expands its own
    # (key-range sharding keeps a key's occurrences on one shard, so a
    # shard's local count is the global one or 0)
    fallback = fallback | (torch.where(kept, cnts, 0).sum(1) > cfg.A)
    qstrand = (ys & 1).to(I32)
    halves = []
    for (starts, cnts_local), sh in zip(looked, shards):
        sdev = starts.device
        halves.append(_expand_hits(
            starts, torch.where(kept.to(sdev), cnts_local, 0), qpos.to(sdev),
            qstrand.to(sdev), sh["positions"], extracted.to(sdev), cfg.A)[:6])
    if len(halves) == 1:
        fk, fq, fok, rk, rq, rok = halves[0]
    else:
        fk, fq, fok = merge_hits(*(all_gather_ref([h[i] for h in halves], dev)
                                   for i in (0, 1, 2)))
        rk, rq, rok = merge_hits(*(all_gather_ref([h[i] for h in halves], dev)
                                   for i in (3, 4, 5)))
    return fallback, shift, extracted, mv_n, capped, fk, fq, fok, rk, rq, rok


def merge_hits(keys, qpos, valid):
    """One strand's gathered shard streams [B, A * n_ref] sorted by key,
    unsigned and stable (device_step.py:1029-1043): equal keys of two
    shards stay in shard order, invalid hits (key U64_MAX) sort last, so
    the stream stays valid-first."""
    perm = u64.argsort_u64(keys, dim=1)
    return (torch.gather(keys, 1, perm), torch.gather(qpos, 1, perm),
            torch.gather(valid, 1, perm))


# ---------------------------------------------------------------------------
# phase 4: vote (plain loop over the hit stream)
# ---------------------------------------------------------------------------
def vote_scan(keys, qpos, valid, strand, vt_distance, vt_threshold,
              vt_rec_threshold, K: int) -> dict:
    """vote (map.c:447-584) over the concatenated fwd/rev hit stream
    (device_step.py:53-170): top-K candidates kept by the reference's
    insertion (one backward bubble pass) plus the recovery candidate.
    ``strand`` [M] int is the per-column strand. The plain version of
    ``csrc/vote_scan.cu``; ``vote_calls`` counts its calls."""
    vote_calls.n += 1
    strand = strand.tolist()
    B, M = keys.shape
    dev = keys.device

    def z(dtype, n=None, fill=0):
        shape = (B,) if n is None else (B, n)
        return torch.full(shape, fill, dtype=dtype, device=dev)

    head_t, head_valid = z(I64), z(torch.bool)
    head_str, fq, lq, cnt = z(I32), z(I32), z(I32), z(I32)
    # the K slots' (score, target, fq, lq, strand), one int64 tensor
    slots = torch.zeros((B, K, 5), dtype=I64, device=dev)
    slots[:, :, 0] = -1
    out_len = z(I32)
    r_score, r_target, r_fq, r_lq, r_str = z(I32), z(I64), z(I32), z(I32), z(I32)

    def emit(do_emit):
        nonlocal slots, out_len, r_score, r_target, r_fq, r_lq, r_str
        passes = do_emit & (cnt > vt_threshold)
        full = out_len == K
        insert = passes & ~(full & (slots[:, K - 1, 0] >= cnt))
        if bool(insert.any()):
            slot = torch.where(full, K - 1, out_len).to(I64)
            ins = insert[:, None] & (torch.arange(K, device=dev)[None, :] == slot[:, None])
            val = torch.stack([cnt.to(I64), head_t, fq.to(I64), lq.to(I64),
                               head_str.to(I64)], 1)
            slots = torch.where(ins[:, :, None], val[:, None, :], slots)
            for kk in range(K - 1, 0, -1):  # the reference's insertion loop
                swap = (insert & (slots[:, kk, 0] > slots[:, kk - 1, 0]))[:, None]
                a, b = slots[:, kk - 1].clone(), slots[:, kk].clone()
                slots[:, kk] = torch.where(swap, a, b)
                slots[:, kk - 1] = torch.where(swap, b, a)
        new_len = torch.where(insert & ~full, out_len + 1, out_len)
        rec = (do_emit & ~passes & (out_len == 0) & (cnt > vt_rec_threshold)
               & (cnt > r_score))
        out_len = new_len
        r_score = torch.where(rec, cnt, r_score)
        r_target = torch.where(rec, head_t, r_target)
        r_fq = torch.where(rec, fq, r_fq)
        r_lq = torch.where(rec, lq, r_lq)
        r_str = torch.where(rec, head_str, r_str)

    # a column with no valid hit in any row, after another such column (or
    # first), changes no output: every run has ended and no head is valid,
    # and the next valid column starts its run afresh
    live = valid.any(0).tolist()
    for m in range(M):
        if not live[m] and (m == 0 or not live[m - 1]):
            continue
        t, q, ok, sgn = keys[:, m], qpos[:, m], valid[:, m], strand[m]
        in_run = head_valid & ok & (head_str == sgn) & u64.ule(t - head_t, vt_distance)
        ext_f = in_run & (q < fq)
        new_fq = torch.where(ext_f, q, fq)
        new_head = torch.where(ext_f, t, head_t)
        new_lq = torch.where(in_run & (q > lq), q, lq)
        emit(head_valid & ~in_run)
        head_t = torch.where(in_run, new_head, t)
        fq = torch.where(in_run, new_fq, q)
        lq = torch.where(in_run, new_lq, q)
        cnt = torch.where(in_run, cnt + 1, 1)
        head_valid = in_run | ok
        head_str = torch.where(in_run, head_str, sgn)
    emit(head_valid)
    k_score, k_target, k_fq, k_lq, k_str = slots.unbind(2)
    return {"k_score": k_score.to(I32), "k_target": k_target.contiguous(),
            "k_fq": k_fq.to(I32), "k_lq": k_lq.to(I32), "k_str": k_str.to(I32),
            "out_len": out_len,
            "r_score": r_score, "r_target": r_target, "r_fq": r_fq,
            "r_lq": r_lq, "r_str": r_str}


# ---------------------------------------------------------------------------
# phases 7-8 helpers: windows, backtrack, packing
# ---------------------------------------------------------------------------
def window_rows_packed(packed, nmask, fstart, L: int):
    """out[n, j] = reference code at base fstart[n]+j from the 2-bit pack,
    4 where the N mask is set (device_step.py:1106-1139). Out-of-range
    bases are clamped; callers mask them."""
    total = packed.shape[0] * 4
    p = torch.clamp(fstart[:, None] + torch.arange(L, dtype=I64, device=fstart.device),
                    0, total - 1)
    out = (packed[p >> 2].to(I32) >> (2 * (p & 3)).to(I32)) & 3
    if nmask is not None:
        # for an n-base reference p < 4*ceil(n/4) <= 8*ceil(n/8), so p >> 3
        # stays inside the mask's ceil(n/8) bytes
        nb = (nmask[p >> 3].to(I32) >> (p & 7).to(I32)) & 1
        out = torch.where(nb != 0, 4, out)
    return out.to(torch.uint8)


def backtrack_antidiag(dirs, dp_lens, band, Lmax: int, tlens=None,
                       Lt: int | None = None, fold: bool = False,
                       band_budget: int | None = None, unroll: int | None = None):
    """Antidiagonal-synchronous ksw_backtrack (ksw2.h:131-163), as
    device_step.py:452-585. Ops stream back to front, one column per
    antidiagonal r = Rpad-1 .. 0 (R padded to a multiple of 8), 255 on idle
    columns.

    ``fold=False`` reads the dirs [N, R, Wd] of ops/dp.py, or, when
    ``band_budget``'s lane window engages at (round128(Lt), ``unroll``),
    the windowed dirs of ops/dp_band.py: lane i of wavefront r at column
    i - window_base(r // unroll * unroll). ``fold=True`` reads the raw
    folded layout of ops/dp_fold.py, [(C+1)*H, Nrows, Wd]: candidate n =
    c*Nrows + k takes wavefront r from slice c*H + r, at lane i + FOLD_GAP
    for the second half (r >= H). ``calls`` counts the invocations.
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


PACK_B = ("shift", "extracted", "fallback")
PACK_BK = ("c_valid", "c_score", "c_strand", "chrom", "so", "ts",
           "length", "exact", "dp_score", "fin_i", "fin_j", "opsrow")


def pack_outputs(fields: dict):
    """[B]-fields + [B, K]-fields -> one [B, 3+12K] i32 tensor."""
    cols = [fields[n].to(I32)[:, None] for n in PACK_B]
    cols += [fields[n].to(I32) for n in PACK_BK]
    return torch.cat(cols, dim=1)


def unpack_outputs(meta: np.ndarray, K: int) -> dict:
    out = {}
    for c, name in enumerate(PACK_B):
        out[name] = meta[:, c]
    for f, name in enumerate(PACK_BK):
        out[name] = meta[:, 3 + f * K: 3 + (f + 1) * K]
    for name in ("fallback", "c_valid", "exact"):
        out[name] = out[name].astype(bool)
    out["eo"] = out["so"] + out["length"] - 1
    out["te"] = out["ts"] + out["length"] - 1
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def fused_map_step(codes, lens, tables: dict, cfg: StepConfig,
                   upto: str | None = None, mark=None):
    """The fused forward step (device_step.py:1142-1393).

    codes [B, Lmax] u8 (255 pad), lens [B] i64, ``tables`` from
    ``TorchFusedMapper`` (or one data row's of ``parallel.dist``'s sharded
    step). ``upto`` cuts the step for the five-stage profile:
    ``"pattern"`` returns (fallback, shift), ``"seed"`` the sorted hit
    streams (fk, fq, fok, rk, rq, rok), ``"vote"`` the vote dict; otherwise
    {"meta": [B, 3+12K] i32, "ops": [N2, OB] u8}. ``mark(name)``, when
    given, is called at each phase boundary (front, vote, windows, dp,
    backtrack) for per-phase device timing."""
    def _mark(name):
        if mark is not None:
            mark(name)

    B = codes.shape[0]
    dev = codes.device
    k, K = cfg.k, cfg.K
    if upto == "pattern":
        return collect_hits(codes, lens, tables, cfg, upto="pattern")
    fallback, shift, extracted, mv_n, capped, fk, fq, fok, rk, rq, rok = (
        collect_hits(codes, lens, tables, cfg))
    _mark("front")
    if upto == "seed":
        return fk, fq, fok, rk, rq, rok

    # ---- phase 4: voting (float64 thresholds, truncated) ----
    lens_f = lens.to(torch.float64)
    bw = torch.clamp((lens_f * cfg.bw_frac).to(I64), cfg.bw_min, cfg.bw_max)
    capped_mask = capped & cfg.frag_mode & (extracted < lens)
    mv_f = mv_n.to(torch.float64)
    vt_thr = torch.where(capped_mask, int(cfg.max_nb_seeds * cfg.min_cnt),
                         (mv_f * cfg.min_cnt).to(I64))
    vt_thr = torch.clamp(vt_thr, min=1)
    vt_rec = torch.where(capped_mask, int(cfg.max_nb_seeds * cfg.rec_frac),
                         (mv_f * cfg.rec_frac).to(I64))
    # the halves are read in place (valid-first, as ops/vote.py requires)
    vt = vote.vote_scan(fk, fq, fok, rk, rq, rok, bw, vt_thr.to(I32), vt_rec.to(I32), K)
    _mark("vote")
    if upto == "vote":
        return vt

    # ---- phase 5: candidates (top-K + recovery substitution) ----
    use_rec = ((vt["out_len"] == 0) & (vt["r_score"] > 0))[:, None]
    slot = torch.arange(K, dtype=I32, device=dev)[None, :]
    c_valid = torch.where(use_rec, slot == 0, slot < vt["out_len"][:, None])
    c_tgt = torch.where(use_rec, vt["r_target"][:, None], vt["k_target"])
    c_str = torch.where(use_rec, vt["r_str"][:, None], vt["k_str"])
    c_score = torch.where(use_rec, vt["r_score"][:, None], vt["k_score"])
    off = torch.where(c_str != 0, 0, -extracted[:, None])
    loc = _to_i32((c_tgt & U32) + off)
    loc = torch.where(c_str != 0, loc - (k - 1), loc)

    # ---- phase 6: window geometry (map.c:764-840) ----
    ref_lengths = tables["ref_lengths"]
    chrom = srl(c_tgt, 32)
    chrom_c = torch.clamp(chrom, 0, max(ref_lengths.shape[0] - 1, 0))
    tlen = ref_lengths[chrom_c]
    qlen = lens[:, None]
    so_r = torch.clamp(loc - (tlen - 1), min=0)
    te_r = torch.minimum(loc, tlen - 1)
    cond_r = te_r < qlen - so_r - 1
    eo_r = torch.where(cond_r, so_r + te_r, qlen - 1)
    ts_r = torch.where(cond_r, 0, te_r - (eo_r - so_r))
    so_f = torch.clamp(-loc, min=0)
    ts_f = torch.clamp(loc, min=0)
    cond_f = (tlen - ts_f) < (qlen - so_f)
    eo_f = torch.where(cond_f, tlen - 1 - ts_f + so_f, qlen - 1)
    te_f = torch.where(cond_f, tlen - 1, ts_f + (eo_f - so_f))
    rev = c_str != 0
    so = torch.where(rev, so_r, so_f)
    eo = torch.where(rev, eo_r, eo_f)
    ts = torch.where(rev, ts_r, ts_f)
    te = torch.where(rev, te_r, te_f)
    length = eo - so + 1
    bad = (length <= 0) | (length > cfg.Lmax) | (ts < 0)
    fallback = fallback | (c_valid & bad).any(1)
    live = c_valid & ~bad

    # ---- phase 7: window gathers (plain, clamped; masked below) ----
    L = cfg.Lmax
    j = torch.arange(L, dtype=I64, device=dev)
    in_win = j[None, None, :] < length[:, :, None]
    keep = in_win & live[:, :, None]
    s0 = torch.where(rev, eo - (L - 1), so)
    fstart_q = torch.arange(B, dtype=I64, device=dev)[:, None] * L + s0
    qidx = torch.clamp(fstart_q[:, :, None] + j, 0, B * L - 1)
    qraw = codes.reshape(-1)[qidx].to(I32)
    qg = torch.where(rev[:, :, None], torch.flip(qraw, [2]) ^ 3, qraw)
    qbuf = torch.where(keep, qg, 0).to(torch.uint8)
    fstart_t = tables["ref_offsets"][chrom_c] + ts
    packed, nmask = tables["ref_codes"], tables["ref_nmask"]
    tg = window_rows_packed(packed, nmask, fstart_t.reshape(-1), L).reshape(B, K, L)
    tbuf = torch.where(keep, tg, 0)

    # ---- phase 8: exact match, substitution-only, DP-row compaction ----
    exact = (qlen < 300) & live & (qbuf == tbuf).all(2)
    m_safe = _max_safe_subs(cfg.params)
    mism = ((qbuf != tbuf) & in_win).sum(2, dtype=I32)
    nfree = ~(((qbuf > 3) | (tbuf > 3)) & in_win).any(2)
    sub_only = live & ~exact & nfree & (mism <= m_safe) & ((eo - so) == (te - ts))
    N = B * K
    need = (live & ~exact & ~sub_only).reshape(N)
    N2 = dp_rows(N, cfg.dp_frac)
    bandN = bw[:, None].expand(B, K).reshape(N).to(I32)
    dp_lens = torch.where(exact | ~live, 0, length).to(I32).reshape(N)
    perm = torch.sort((~need).to(I32), stable=True).indices
    rank = torch.empty_like(perm).scatter_(0, perm, torch.arange(N, device=dev))
    overflow = need & (rank >= N2)
    fallback = fallback | overflow.reshape(B, K).any(1)
    sel = perm[:N2]
    qb2 = qbuf.reshape(N, L)[sel].contiguous()
    tb2 = tbuf.reshape(N, L)[sel].contiguous()
    len2 = dp_lens[sel].contiguous()
    band2 = bandN[sel].contiguous()
    _mark("windows")

    score2, dirs, _, _ = extd2.extd2_batch(
        qb2, tb2, len2, band2, cfg.params, L, fold=cfg.dp_fold,
        state_dtype=extd2.route_state_dtype(cfg.params, L, fold=cfg.dp_fold))
    _mark("dp")
    rank_c = torch.clamp(rank, 0, N2 - 1)
    score = torch.where(need, score2[rank_c], 0).reshape(B, K)
    a_, b_ = cfg.params[0], cfg.params[1]
    score = torch.where(sub_only, (a_ * (length - mism) - b_ * mism).to(I32), score)
    score = torch.where(exact, (qlen * cfg.match_a).to(I32), score)

    # SR windows have tlen = qlen
    ops2, fin_i2, fin_j2 = extd2.backtrack_band(dirs, len2, len2, band2, L, L,
                                                fold=cfg.dp_fold)
    fin_i = torch.where(need, fin_i2[rank_c], 0)
    fin_j = torch.where(need, fin_j2[rank_c], 0)
    pad = (-ops2.shape[1]) % 4
    if pad:
        ops2 = torch.cat([ops2, torch.full((N2, pad), 255, dtype=torch.uint8,
                                           device=dev)], 1)
    ops_packed = pack_ops(ops2)

    # opsrow: >=0 compacted op row; -2 all-M (sub_only); -1 no CIGAR
    opsrow = torch.where(need & ~overflow, rank, -1).reshape(B, K)
    opsrow = torch.where(sub_only, -2, opsrow)
    meta = pack_outputs({
        "shift": shift, "extracted": extracted, "fallback": fallback,
        "c_valid": live, "c_score": c_score, "c_strand": c_str,
        "chrom": chrom, "so": so, "ts": ts, "length": length,
        "exact": exact, "dp_score": score, "fin_i": fin_i.reshape(B, K),
        "fin_j": fin_j.reshape(B, K), "opsrow": opsrow,
    })
    _mark("backtrack")
    return {"meta": meta, "ops": ops_packed}


def step_config(index, mo, Lmax: int, S: int, S2: int, A: int) -> StepConfig:
    """StepConfig of a mapper's budgets: the seed budgets capped at the
    diet length of the longest read (device_step.py:1402-1407)."""
    return at_width(StepConfig.from_options(index, mo, index.derive_mid_occ(mo), Lmax,
                                            S, S2, A), Lmax)


def at_width(cfg: StepConfig, Lmax: int) -> StepConfig:
    """``cfg`` for rows of ``Lmax`` bases, its seed budgets capped at their
    diet length. A read has fewer seeds than its diet length, so a cap
    below the budget never sends a read back that the budget keeps: the
    same reads map alike at any width that holds them."""
    dmax = pattern.diet_length(Lmax, cfg.pattern, 0)
    return dataclass_replace(cfg, Lmax=Lmax, S=min(cfg.S, dmax), S2=min(cfg.S2, dmax))


def ref_tables(index, cfg: StepConfig, dev) -> dict:
    """The step's reference tables on ``dev``: the 2-bit packed reference
    and its N mask, sequence offsets and lengths, the pattern tables.
    ``.to()`` is a no-op where the index already lives."""
    maps, pref, _ = _pattern_tables(cfg)
    packed, nmask = index.device_packed()
    return {
        "ref_codes": packed.to(dev),
        "ref_nmask": None if nmask is None else nmask.to(dev),
        "ref_offsets": torch.from_numpy(np.asarray(index.seq_offsets, np.int64)).to(dev),
        "ref_lengths": torch.from_numpy(np.asarray(index.lengths, np.int64)).to(dev),
        "maps": torch.from_numpy(maps).to(dev),
        "pref": torch.from_numpy(pref).to(dev),
    }


# the five-stage profile's cuts of the step, in order (device_step.py:1520)
STAGE_CUTS = (("pattern", "pattern"), ("seed", "seed"), ("vote", "vote"), ("align", None))
STAGE_REPS = 5  # timed runs of each cut; staged_times takes the fastest


class TorchFusedMapper:
    """Device tables + the fused step for one configuration
    (device_step.py:1396-1517), on an explicit device."""

    def __init__(self, index, mo, Lmax: int = 256, S: int = 160, S2: int = 64,
                 A: int = 2048, dp_frac: float = 1.0, device=None,
                 dp_fold: bool = False):
        self.device = torch.device(device if device is not None else index.device)
        cfg = step_config(index, mo, Lmax, S, S2, A)
        tkv, c1, c2, nb = index.device_cuckoo_kv()
        # dp_fold folds the DP where the banded lane window cannot engage
        # (device_step.py:1325-1328); resolved once per mapper
        fold = dp_fold and window_geometry(cfg.bw_max, -(-Lmax // 128) * 128) is None
        self.cfg = dataclass_replace(cfg, dp_frac=dp_frac, cuckoo_c1=c1, cuckoo_c2=c2,
                                     cuckoo_nb=nb, dp_fold=fold)
        dev = self.device
        self.tables = {**ref_tables(index, self.cfg, dev), "cuckoo": tkv.to(dev),
                       "positions": index.device_positions().to(dev)}

    def inputs(self, codes: np.ndarray, lens: np.ndarray):
        """Host numpy batch -> (codes, lens) tensors on the device."""
        c = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(self.device)
        ln = torch.from_numpy(np.ascontiguousarray(lens, np.int64)).to(self.device)
        return c, ln

    def step(self, codes, lens, upto: str | None = None, mark=None):
        """``fused_map_step`` on device tensors from ``inputs``."""
        return fused_map_step(codes, lens, self.tables, self.cfg, upto=upto, mark=mark)

    def __call__(self, codes: np.ndarray, lens: np.ndarray, mark=None) -> dict:
        """Dispatch one batch (host numpy in); returns device tensors."""
        return self.step(*self.inputs(codes, lens), mark=mark)

    def fetch(self, dev: dict, B: int):
        """Device outputs -> (meta [B, 3+12K] i32, ops [N2, OB] u8) numpy."""
        return dev["meta"][:B].cpu().numpy(), dev["ops"].cpu().numpy()

    def sync(self) -> None:
        """Wait for the work queued on the mapper's card(s)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def staged_times(self, codes: np.ndarray, lens: np.ndarray) -> dict:
        return staged_times(self, codes, lens)


def staged_times(mapper, codes: np.ndarray, lens: np.ndarray) -> dict:
    """Five-stage profile of one batch (the reference's -DPROFILE split,
    profile.h:6-28; device_step.py:1520-1572) on ``mapper`` (a
    ``TorchFusedMapper`` or ``parallel.dist.ShardedFused``): the step cut
    at each stage's end (``STAGE_CUTS``) is run once to warm up, then timed
    ``STAGE_REPS`` times, each run synchronised; returns the marginal
    seconds of pattern, seed, vote and align from each cut's fastest run,
    each clipped at 0. A re-run estimate, like a profiling build.

    ``gdiet_tpu`` times each cut once. On the card the vote stage adds
    ~0.05 ms to a ~12 ms cut, less than one timing's spread while the
    pipeline's producer thread enqueues the next batch (a single timing
    gave the vote 0 ns on both batches of a 10,016-read run, NVIDIA H100
    80GB HBM3, 700.00 W); interference only adds time, so the fastest of a
    few runs is the steadier reading."""
    c, ln = mapper.inputs(codes, lens)
    out, prev = {}, 0.0
    for name, upto in STAGE_CUTS:
        mapper.step(c, ln, upto=upto)
        mapper.sync()
        best = float("inf")
        for _ in range(STAGE_REPS):
            t0 = time.perf_counter()
            mapper.step(c, ln, upto=upto)
            mapper.sync()
            best = min(best, time.perf_counter() - t0)
        out[name] = max(best - prev, 0.0)
        prev = best
    return out
