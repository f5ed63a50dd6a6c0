"""The long-read mapper's host finish on packed CIGARs.

Each DP chunk's result stays packed from the device to the fixed CIGAR:
the op streams are run-length encoded by the C ``rle_ops`` into a
[rows, max_runs] matrix of ``len << 4 | op`` runs, and one C
``update_extra_full_batch`` call over the chunk's live rows runs
``mm_fix_cigar`` and the rescoring scan (align.c:93-172, 259-318) in place,
reading the chunk's staged query and target matrices (the windows,
unshifted). Only the fixed runs become ``(len, op)`` tuples, in one
vectorised pass a row. ``finish_read`` then builds each read's ``Reg``s from
those rows as ``oal.update_extra_many`` does, and runs the rest of
``olr.finalize_read`` (map.c:1808-1912): the clip check, concatenation,
the ``min_dp_max`` filter, the score ordering and ``set_sam_params``.

Segments without a packed row take ``oal.update_extra`` per record, as
``olr.finalize_read`` does: exact matches, segments aligned by the host's
DP, and every row of a chunk whose runs overflow the runs matrix. A finished
segment is counted in ``stats["finish_segments"]``, one of those in
``stats["finish_py_segments"]`` too.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gdiet_tpu_torch import native
from gdiet_tpu_torch.config import MM_F_NO_PRINT_2ND, MM_F_SR
from gdiet_tpu_torch.ops.backtrack import unpack_ops
from gdiet_tpu_torch.ops.dp import cigars_from_ops
from gdiet_tpu_torch.oracle import align as oal
from gdiet_tpu_torch.oracle import longread as olr
from gdiet_tpu_torch.oracle.pipeline import set_sam_params


def rle_runs(op_rows, fin_i, fin_j, qlens, max_runs: int):
    """The C ``rle_ops`` on back-to-front op streams [n, S] (>= 3 pad):
    (runs [n, max_runs] u32 of ``len << 4 | op``, front to back, n_runs
    [n] i64), or None if a row has more than ``max_runs`` runs."""
    n, smax = op_rows.shape
    op_rows = np.ascontiguousarray(op_rows, np.uint8)
    fin_i = np.ascontiguousarray(fin_i, np.int32)
    fin_j = np.ascontiguousarray(fin_j, np.int32)
    lens = np.ascontiguousarray(qlens, np.int64)
    runs = np.empty((n, max_runs), np.uint32)
    n_runs = np.empty(n, np.int32)
    ptr = native._ptr
    if native.lib.rle_ops(ptr(op_rows, ctypes.c_uint8), n, smax, ptr(fin_i, ctypes.c_int32),
                          ptr(fin_j, ctypes.c_int32), ptr(lens, ctypes.c_int64),
                          ptr(runs, ctypes.c_uint32), max_runs, ptr(n_runs, ctypes.c_int32)):
        return None
    return runs, n_runs.astype(np.int64)


def fix_and_rescore(runs, n_runs, rows, Q, T, mo) -> np.ndarray:
    """``mm_fix_cigar`` and the rescoring scan of ``rows`` in one C call:
    row j's runs ``runs[j, :n_runs[j]]`` are fixed in place over the
    windows ``Q[j]`` and ``T[j]``, and ``n_runs[j]`` set to their new count.
    Returns [len(rows), 8] i64: blen, mlen, n_ambi, dp_max, qoff, toff,
    lead_op, lead_len (the leading I/D dropped)."""
    for a, dt in ((Q, np.uint8), (T, np.uint8), (runs, np.uint32)):
        if a.dtype != dt or a.ndim != 2 or not a.flags.c_contiguous:
            raise ValueError(f"expected a C-contiguous 2-D {np.dtype(dt)} array, "
                             f"got {a.dtype} {a.shape}")
    rows = np.asarray(rows, np.int64)
    if len(rows) and not (rows.min() >= 0 and rows.max() < min(len(Q), len(T), len(runs))
                          and (n_runs[rows] <= runs.shape[1]).all()):
        raise ValueError("a row outside the chunk, or more runs than it holds")
    out = np.zeros((len(rows), 8), np.int64)
    if not len(rows):
        return out
    qoffs = rows * Q.shape[1]
    toffs = rows * T.shape[1]
    cigoffs = rows * runs.shape[1]
    cign = np.ascontiguousarray(n_runs[rows], np.int64)
    ptr = native._ptr
    native.lib.update_extra_full_batch(
        ptr(Q, ctypes.c_uint8), ptr(qoffs, ctypes.c_int64),
        ptr(T, ctypes.c_uint8), ptr(toffs, ctypes.c_int64),
        ptr(runs, ctypes.c_uint32), ptr(cigoffs, ctypes.c_int64),
        ptr(cign, ctypes.c_int64), len(rows), mo.a, mo.b, mo.q, mo.e,
        0 if mo.flag & MM_F_SR else 1, ptr(out, ctypes.c_int64))
    n_runs[rows] = cign
    return out


def chunk_results(packed: np.ndarray, qlens, Q, T, mo) -> list:
    """One DP chunk's packed result [N, 12 + S/4] u8 (score | fin_i | fin_j
    | 2-bit ops) to a (score, cigar, row) per row, as ``runs_results``
    gives them; when a row has more than ``max(1024, S / 4)`` runs every
    row's ``cigar`` is the DP's own and its ``row`` None."""
    score = packed[:, :4].copy().view(np.int32)[:, 0]
    fin_i = packed[:, 4:8].copy().view(np.int32)[:, 0]
    fin_j = packed[:, 8:12].copy().view(np.int32)[:, 0]
    op_rows = unpack_ops(packed[:, 12:])
    rle = rle_runs(op_rows, fin_i, fin_j, qlens, max(1024, op_rows.shape[1] // 4))
    if rle is not None:
        return runs_results(score, *rle, Q, T, mo)
    cigs = cigars_from_ops(op_rows, fin_i, fin_j, qlens)
    return [(int(sc), cigs[j], None) if sc != oal.NEG_INF else (oal.NEG_INF, [], None)
            for j, sc in enumerate(score)]


def runs_results(score, runs, n_runs, Q, T, mo) -> list:
    """Rows of packed runs to a (score, cigar, row) each: ``row`` the 8
    fields of ``fix_and_rescore`` and ``cigar`` its fixed runs as (len, op)
    tuples; a row scoring ``NEG_INF`` gives (NEG_INF, [], None)."""
    out = [(oal.NEG_INF, [], None)] * len(score)
    live = [j for j, sc in enumerate(score) if sc != oal.NEG_INF]
    fields = fix_and_rescore(runs, n_runs, live, Q, T, mo).tolist()
    for j, row in zip(live, fields):
        p = runs[j, : n_runs[j]]
        out[j] = (int(score[j]), list(zip((p >> 4).tolist(), (p & 15).tolist())), row)
    return out


def _apply_row(r: oal.Reg, row) -> None:
    """A ``fix_and_rescore`` row onto its Reg (oal.update_extra_many)."""
    lead_op, lead_len = row[6], row[7]
    if lead_op == oal.CIGAR_INS:  # drop leading I/D (align.c:160-171)
        if r.rev:
            r.qe -= lead_len
        else:
            r.qs += lead_len
    elif lead_op == oal.CIGAR_DEL:
        r.rs += lead_len
    r.blen = r.mlen = 0
    oal._apply_scan(r, row[:6])


def finish_read(mi, mo, qs_for, qs_rev, qlen_sum, seqs, jobs, results, stats) -> list:
    """``olr.finalize_read`` on (score, cigar, row) results: Reg
    construction from the packed rows (per-record ``oal.update_extra`` for
    a row of None), the clip check, concatenation, the score filter and
    the output ordering (map.c:1808-1912)."""
    log_gap = not (mo.flag & MM_F_SR)
    for (s, qwin, twin, _exact, _qlen), (score, cigar, row) in zip(jobs, results):
        query_start, query_end, target_start, target_end = s.win
        if score == oal.NEG_INF:
            s.valid = 0
            continue
        r = oal.Reg(rid=s.chrom_id, score=score, qs=query_start, qe=query_end + 1,
                    rs=target_start, re=target_end + 1, rev=s.str,
                    cigar=list(cigar), dp_score=score)
        stats["finish_segments"] += 1
        if row is None:
            stats["finish_py_segments"] += 1
            oal.update_extra(r, qwin, twin, mo.a, mo.b, mo.q, mo.e, log_gap=log_gap)
        else:
            _apply_row(r, row)
        clip0 = qlen_sum - r.qe if r.rev else r.qs
        clip1 = r.qs if r.rev else qlen_sum - r.qe
        if not (clip0 < qlen_sum and clip1 < qlen_sum):
            s.valid = 0
            continue
        s.r = r

    # ---- concatenate the records (map.c:1857-1874) ----
    for s in seqs:
        while s.valid and s.next is not None and s.next.valid:
            if olr.concatenate_cigars(
                s.r, s.next.r, qs_rev if s.str else qs_for, s.str, qlen_sum,
                mi, mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2,
            ) == 0:
                s.next.valid = 0
                s.next = s.next.next
            else:
                s.next = None

    # ---- score filter + output ordering (map.c:1876-1912) ----
    out: list[oal.Reg] = []
    for s in seqs:
        if s.valid:
            if s.r.dp_score < mo.min_dp_max:
                s.valid = 0
            else:
                out.append(s.r)
                kk = len(out) - 1
                while kk > 0 and out[kk].score > out[kk - 1].score:
                    out[kk], out[kk - 1] = out[kk - 1], out[kk]
                    kk -= 1
    if out:
        max_nb_sec = 0 if (mo.flag & MM_F_NO_PRINT_2ND) else mo.best_n
        set_sam_params(out, qlen_sum, mo.a, max_nb_sec)
    return out
