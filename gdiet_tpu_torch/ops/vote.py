"""The vote kernels' wrappers and their plain versions: the short-read
vote (``csrc/vote_scan.cu``) and the long-read round-1 and round-2 votes
(``csrc/vote_lr.cu``).

Each wrapper takes the two strand halves of a hit stream in place, as
``pipeline/device_step.py::collect_hits`` returns them (``fk, fq, fok, rk,
rq, rok``, [B, A] each). The plain versions walk their concatenation
fwd | barrier | rev | barrier (``concat_stream``), whose barrier columns
are invalid; the kernels read the halves where they lie.

For CUDA tensors each wrapper launches its hand-written kernel (built with
``nvcc`` for ``sm_90a`` at first use by ``ops/extd2.py``'s ``build_all``
and bound with ctypes); for CPU tensors it runs the plain version on the
concatenated stream. There is no fallback from one to the other: a CUDA
call launches or raises. ``launches`` counts ``vote_scan.cu``'s launches,
``lr_launches`` those of ``vote_lr.cu`` (both entry points);
``vote_calls`` counts the calls of the short-read plain loop
(``_vote_scan``), ``lr_vote_calls`` those of the long-read ones
(``_vote_scan_lr``, ``_vote2_scan``).

Precondition of every entry point: in each half of each row the valid
columns come first. The hit collection's streams meet it: each strand is
sorted by key (``u64.argsort_u64``), an invalid hit's key is U64_MAX and a
valid key (chrom << 32 | position, chrom a reference index) is smaller.
The kernels stop reading a half after its last valid column, and the plain
long-read loops visit only the columns ``_stream_columns`` gives: those
where some read still has a hit plus one invalid column per strand (a run
of invalid columns acts as one: it closes the open run and leaves nothing
open). On a stream that breaks the precondition their results are
undefined. (The plain short-read loop walks every column and needs no
precondition.) uint64 keys are int64 bit patterns (``u64.py``).
"""
from __future__ import annotations

import torch

from gdiet_tpu_torch import u64
from gdiet_tpu_torch.ops import LaunchCount, extd2
from gdiet_tpu_torch.u64 import U32, srl

I64 = torch.int64
I32 = torch.int32

launches = LaunchCount()
lr_launches = LaunchCount()
vote_calls = LaunchCount()
lr_vote_calls = LaunchCount()

OUTPUTS = ("k_score", "k_target", "k_fq", "k_lq", "k_str", "out_len",
           "r_score", "r_target", "r_fq", "r_lq", "r_str")
LR_OUTPUTS = ("k_score", "k_first_t", "k_last_t", "k_fq", "k_lq", "k_str", "out_len")


def concat_stream(fk, fq, fok, rk, rq, rok):
    """The plain versions' stream: (keys [B, M] int64, qpos [B, M] int32,
    valid [B, M] bool, strand [M] int32) with M = 2(A+1), the halves each
    followed by an invalid barrier column (key U64_MAX, position 0)."""
    B, A = fk.shape
    dev = fk.device
    barrier = torch.full((B, 1), -1, dtype=torch.int64, device=dev)  # U64_MAX
    bq = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    bok = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    strand = (torch.arange(2 * (A + 1), device=dev) > A).to(torch.int32)
    return (torch.cat([fk, barrier, rk, barrier], 1), torch.cat([fq, bq, rq, bq], 1),
            torch.cat([fok, bok, rok, bok], 1), strand)


def _check(name, t, dtype, shape, device, contiguous: bool = True):
    if t.device != device:
        raise ValueError(f"vote: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"vote: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"vote: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"vote: {name} is not contiguous")


def _halves(fk, fq, fok, rk, rq, rok) -> tuple:
    """Check the six halves for a kernel and return (B, A, ld, pointers):
    [B, A] each, unit column stride and one row stride ``ld`` for all."""
    B, A = fk.shape
    dev = fk.device
    ld = None
    for name, t, dtype in (("fk", fk, torch.int64), ("fq", fq, torch.int32),
                           ("fok", fok, torch.bool), ("rk", rk, torch.int64),
                           ("rq", rq, torch.int32), ("rok", rok, torch.bool)):
        _check(name, t, dtype, (B, A), dev, contiguous=False)
        row = t.stride(0) if B > 1 else max(A, 1)
        if A > 1 and t.stride(1) != 1:
            raise ValueError(f"vote: {name}'s columns are not contiguous")
        if ld is None:
            ld = row
        elif row != ld:
            raise ValueError(f"vote: {name}'s row stride {row} differs from fk's {ld}")
    if 2 * A + 2 >= 1 << 31:
        raise ValueError(f"vote: {A} columns per half, expected 2A + 2 < 2^31")
    return B, A, max(ld, A), [t.data_ptr() for t in (fk, fq, fok, rk, rq, rok)]


def _empty(shape, dtype, dev):
    return torch.empty(shape, dtype=dtype, device=dev)


def vote_scan(fk, fq, fok, rk, rq, rok, vt_distance, vt_threshold, vt_rec_threshold,
              K: int) -> dict:
    """Vote over the hit stream of each read (map.c:447-584).

    Halves as the module docstring says (keys int64 as uint64 bit patterns,
    positions int32, flags bool); vt_distance [B] int64, vt_threshold and
    vt_rec_threshold [B] int32. Returns {k_score, k_fq, k_lq, k_str: [B, K]
    int32, k_target: [B, K] int64, out_len, r_score, r_fq, r_lq, r_str:
    [B] int32, r_target: [B] int64}, what ``_vote_scan`` returns for the
    concatenated stream."""
    if fk.device.type == "cpu":
        return _vote_scan(*concat_stream(fk, fq, fok, rk, rq, rok), vt_distance,
                          vt_threshold, vt_rec_threshold, K)
    if fk.device.type != "cuda":
        raise ValueError(f"vote_scan: unsupported device {fk.device}")
    if K < 1:
        raise ValueError(f"vote_scan: K = {K}, expected >= 1")
    B, A, ld, ptrs = _halves(fk, fq, fok, rk, rq, rok)
    dev = fk.device
    _check("vt_distance", vt_distance, torch.int64, (B,), dev)
    _check("vt_threshold", vt_threshold, torch.int32, (B,), dev)
    _check("vt_rec_threshold", vt_rec_threshold, torch.int32, (B,), dev)
    out = {}
    for name in OUTPUTS:
        shape = (B, K) if name.startswith("k_") else (B,)
        out[name] = _empty(shape, torch.int64 if name.endswith("target") else torch.int32, dev)
    if B:
        lib = extd2._library("vote_scan")
        with torch.cuda.device(dev):
            rc = lib.gdiet_vote_scan(
                *ptrs, ld, vt_distance.data_ptr(),
                vt_threshold.data_ptr(), vt_rec_threshold.data_ptr(),
                *(out[n].data_ptr() for n in OUTPUTS), B, A, K, extd2._stream(dev))
        if rc != 0:
            raise RuntimeError(f"vote_scan kernel launch failed: CUDA error {rc}")
        launches.n += 1
    return out


def vote_lr(fk, fq, fok, rk, rq, rok, extracted, vt_distance, cov_thr, K: int) -> dict:
    """Round-1 long-read vote (map.c:1052-1180): coverage-gated runs, the
    raw-target span, top-K by count. extracted and vt_distance [B] int64,
    cov_thr [B] int32. Returns {k_score, k_fq, k_lq, k_str: [B, K] int32,
    k_first_t, k_last_t: [B, K] int64, out_len: [B] int32}, what
    ``_vote_scan_lr`` returns for the concatenated stream."""
    if fk.device.type == "cpu":
        keys, qv, okv, strand = concat_stream(fk, fq, fok, rk, rq, rok)
        return _vote_scan_lr(keys, qv, okv, strand.tolist(), extracted, vt_distance,
                             cov_thr, K, _stream_columns(fok, rok))
    if fk.device.type != "cuda":
        raise ValueError(f"vote_lr: unsupported device {fk.device}")
    if K < 1:
        raise ValueError(f"vote_lr: K = {K}, expected >= 1")
    B, A, ld, ptrs = _halves(fk, fq, fok, rk, rq, rok)
    dev = fk.device
    _check("extracted", extracted, torch.int64, (B,), dev)
    _check("vt_distance", vt_distance, torch.int64, (B,), dev)
    _check("cov_thr", cov_thr, torch.int32, (B,), dev)
    out = {name: _empty((B,) if name == "out_len" else (B, K),
                        torch.int64 if name.endswith("_t") else torch.int32, dev)
           for name in LR_OUTPUTS}
    if B:
        lib = extd2._library("vote_lr")
        with torch.cuda.device(dev):
            rc = lib.gdiet_vote_lr(
                *ptrs, ld, extracted.data_ptr(),
                vt_distance.data_ptr(), cov_thr.data_ptr(),
                *(out[n].data_ptr() for n in LR_OUTPUTS), B, A, K, extd2._stream(dev))
        if rc != 0:
            raise RuntimeError(f"vote_lr kernel launch failed: CUDA error {rc}")
        lr_launches.n += 1
    return out


def vote2_pair(fk, fq, fok, rk, rq, rok, extracted, vt_distance, lo1, hi1, lo2,
               hi2) -> torch.Tensor:
    """Round-2 long-read vote (map.c:1182-1271) of both query windows
    (lo1, hi1) and (lo2, hi2), [B] int32 each, exclusive: the [B, 16]
    int32 block ``vote2_packed_pair`` returns for the concatenated
    stream."""
    if fk.device.type == "cpu":
        keys, qv, okv, strand = concat_stream(fk, fq, fok, rk, rq, rok)
        return vote2_packed_pair(keys, qv, okv, strand.tolist(), extracted, vt_distance,
                                 lo1, hi1, lo2, hi2, _stream_columns(fok, rok))
    if fk.device.type != "cuda":
        raise ValueError(f"vote2_pair: unsupported device {fk.device}")
    B, A, ld, ptrs = _halves(fk, fq, fok, rk, rq, rok)
    dev = fk.device
    _check("extracted", extracted, torch.int64, (B,), dev)
    _check("vt_distance", vt_distance, torch.int64, (B,), dev)
    for name, t in (("lo1", lo1), ("hi1", hi1), ("lo2", lo2), ("hi2", hi2)):
        _check(name, t, torch.int32, (B,), dev)
    out = _empty((B, 16), torch.int32, dev)
    if B:
        lib = extd2._library("vote_lr")
        with torch.cuda.device(dev):
            rc = lib.gdiet_vote2_pair(
                *ptrs, ld, extracted.data_ptr(),
                vt_distance.data_ptr(),
                *(t.data_ptr() for t in (lo1, hi1, lo2, hi2)),
                out.data_ptr(), B, A, extd2._stream(dev))
        if rc != 0:
            raise RuntimeError(f"vote2_pair kernel launch failed: CUDA error {rc}")
        lr_launches.n += 1
    return out


# ---------------------------------------------------------------------------
# the plain versions, over the concatenated stream
# ---------------------------------------------------------------------------
def _vote_scan(keys, qpos, valid, strand, vt_distance, vt_threshold,
               vt_rec_threshold, K: int) -> dict:
    """vote (map.c:447-584) over the concatenated fwd/rev hit stream
    (gdiet_tpu/pipeline/device_step.py:53-170): top-K candidates kept by
    the reference's insertion (one backward bubble pass) plus the recovery
    candidate. ``strand`` [M] int is the per-column strand. The plain
    version of ``csrc/vote_scan.cu``; ``vote_calls`` counts its calls."""
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
    """Round-1 vote (gdiet_tpu/pipeline/lr_step.py:41-142): coverage-gated
    runs, raw-target span tracking, score-sorted top-K insertion. The plain
    version of ``csrc/vote_lr.cu``'s round 1."""
    lr_vote_calls.n += 1
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
    """Round-2 vote (gdiet_tpu/pipeline/lr_step.py:146-220): the best run
    constrained to the query window (lo, hi), counting only in-window hits.
    The plain version of ``csrc/vote_lr.cu``'s round 2, one window."""
    lr_vote_calls.n += 1
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


def vote2_packed(keys, qv, okv, strand: list, extracted, vt_dis, lo, hi,
                 cols: list):
    """Round-2 scan with one packed [B, 8] i32 result (gdiet_tpu/pipeline/
    lr_step.py:401)."""
    vt2 = _vote2_scan(keys, qv, okv, strand, extracted, vt_dis, lo, hi, cols)
    return torch.stack([
        vt2["b_score"], vt2["b_fq"], vt2["b_lq"], vt2["b_str"],
        srl(vt2["b_first_t"], 32).to(I32), (vt2["b_first_t"] & U32).to(I32),
        srl(vt2["b_last_t"], 32).to(I32), (vt2["b_last_t"] & U32).to(I32),
    ], dim=1)


def vote2_packed_pair(keys, qv, okv, strand: list, extracted, vt_dis,
                      lo1, hi1, lo2, hi2, cols: list):
    """Both round-2 windows (head gap + tail gap, map.c:1680-1712) as one
    [B, 16] i32 block (gdiet_tpu/pipeline/lr_step.py:391)."""
    return torch.cat([
        vote2_packed(keys, qv, okv, strand, extracted, vt_dis, lo1, hi1, cols),
        vote2_packed(keys, qv, okv, strand, extracted, vt_dis, lo2, hi2, cols),
    ], dim=1)
