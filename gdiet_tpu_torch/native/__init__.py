"""Native host runtime (ctypes-bound C), compiled on first import.

The reference's host runtime is C (bseq/kalloc/kthread); this module keeps
the host-side hot loops native in the rebuild. Falls back to pure Python
transparently when no C compiler is available (``lib`` is None then).

The port's copy of ``gdiet_tpu/native``: the same C source, built at first
import into the package's ``_build/`` directory (cached by source hash).
``require_native`` is the port's own: its short-read and paired-end
finishes have no Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np

_SRC = pathlib.Path(__file__).parent / "gdiet_native.c"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "_build"


def _build() -> ctypes.CDLL | None:
    try:
        src = _SRC.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache = _BUILD / f"gdiet_native_{tag}.so"
    if not cache.exists():
        try:
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = cache.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                ["cc", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, cache)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(cache))
    except OSError:
        return None
    lib.encode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rle_ops.restype = ctypes.c_int
    lib.rle_ops.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.update_extra_full_batch.restype = None
    lib.update_extra_full_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.update_extra_batch.restype = None
    lib.update_extra_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.update_extra_scan.restype = None
    lib.update_extra_scan.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.extd2_approx.restype = ctypes.c_int64
    lib.extd2_approx.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.cuckoo_build_c.restype = ctypes.c_int
    lib.cuckoo_build_c.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
    ]
    lib.radix_sort_kv.restype = None
    lib.radix_sort_kv.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.sr_finish_batch.restype = ctypes.c_int64
    lib.sr_finish_batch.argtypes = (
        [ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
        + [ctypes.c_int64] * 4
        + [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)] * 3
        + [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_int64] * 9
        + [ctypes.c_char_p, ctypes.c_int64,
           ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)]
    )
    lib.pack_codes_batch.restype = None
    lib.pack_codes_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.sdust_flags_batch.restype = None
    lib.sdust_flags_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pe_finish_batch.restype = ctypes.c_int64
    lib.pe_finish_batch.argtypes = (
        [ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
        + [ctypes.c_int64] * 4
        + [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)] * 3
        + [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_int64] * 13
        + [ctypes.c_char_p, ctypes.c_int64,
           ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)]
    )
    return lib


lib = _build()


def require_native():
    """This module, or an error: without the C runtime the SR and PE
    finishes would silently switch to the slow Python regs path."""
    if lib is None:
        raise RuntimeError(
            "gdiet_tpu_torch native library unavailable (no C compiler?): "
            "the port needs sr_finish_batch / pe_finish_batch")
    return sys.modules[__name__]


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def radix_sort_kv(keys: np.ndarray, vals: np.ndarray,
                  vals_presorted: bool = False) -> bool:
    """In-place stable sort of parallel uint64 arrays by (key, val)
    ascending — same order as ``np.lexsort((vals, keys))`` applied to
    both, but O(passes) LSD radix in C (index.c:225-266 analog).
    ``vals_presorted=True`` skips the val digit passes entirely: when the
    input stream is already val-ascending (the device sketch's analytic
    emission order is position-monotonic, so index builds qualify — the
    caller must check), stability of the key passes alone preserves
    val order within equal keys. Roughly halves the scatter passes.
    Returns False (arrays untouched) when the native library is absent.
    """
    if lib is None or len(keys) == 0:
        return lib is not None
    assert keys.dtype == np.uint64 and vals.dtype == np.uint64
    assert keys.flags.c_contiguous and vals.flags.c_contiguous
    key_bits = int(keys.max()).bit_length()
    val_bits = 0 if vals_presorted else int(vals.max()).bit_length()
    tk, tv = np.empty_like(keys), np.empty_like(vals)
    lib.radix_sort_kv(
        _ptr(keys, ctypes.c_uint64), _ptr(vals, ctypes.c_uint64),
        _ptr(tk, ctypes.c_uint64), _ptr(tv, ctypes.c_uint64),
        len(keys), key_bits, val_bits,
    )
    return True


def sdust_flags(seqs: list[str], thres: int, W: int = 64) -> np.ndarray:
    """Per-read SDUST presence flags: 1 iff the read has any masked
    interval at ``thres`` (so -T routing must take the exact host path),
    else 0 — the read's seed stream is provably unaffected by masking
    (map.c:45-72). Returns all-ones when the native library is absent
    (conservative: everything falls back)."""
    n = len(seqs)
    out = np.ones(n, np.uint8)
    if lib is None or n == 0:
        return out
    blob = "".join(seqs).encode()
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    lib.sdust_flags_batch(
        blob, _ptr(offsets, ctypes.c_int64), n, thres, W,
        _ptr(out, ctypes.c_uint8),
    )
    return out


def encode_batch(seqs: list[str], lmax: int) -> tuple[np.ndarray, np.ndarray]:
    """ASCII reads -> ([n, lmax] nt4 codes with 255 padding, [n] lengths)."""
    n = len(seqs)
    blob = "".join(seqs).encode()
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    out = np.full((n, lmax), 255, np.uint8)
    lens = np.zeros(n, np.int64)
    lib.encode_batch(
        blob, _ptr(offsets, ctypes.c_int64), n, lmax,
        _ptr(out, ctypes.c_uint8), _ptr(lens, ctypes.c_int64),
    )
    return out, lens


def pack_codes_batch(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[n, lmax] nt4 codes -> ([n, lmax/4] 2-bit pack, [n, lmax/8] N-mask)
    for the compressed H2D upload (lmax must be a multiple of 8)."""
    n, lmax = codes.shape
    codes = np.ascontiguousarray(codes, np.uint8)
    packed = np.empty((n, lmax // 4), np.uint8)
    nmask = np.empty((n, lmax // 8), np.uint8)
    lib.pack_codes_batch(
        _ptr(codes, ctypes.c_uint8), n, lmax,
        _ptr(packed, ctypes.c_uint8), _ptr(nmask, ctypes.c_uint8),
    )
    return packed, nmask


def rle_ops(
    ops: np.ndarray,  # [n, smax] uint8, contiguous
    fin_i: np.ndarray,
    fin_j: np.ndarray,
    lens: np.ndarray,
    max_runs: int = 256,
) -> list[list[tuple[int, int]]] | None:
    """cigars_from_ops in C; returns None on overflow (caller falls back)."""
    n, smax = ops.shape
    ops = np.ascontiguousarray(ops)
    fin_i = np.ascontiguousarray(fin_i, np.int32)
    fin_j = np.ascontiguousarray(fin_j, np.int32)
    lens64 = np.ascontiguousarray(lens, np.int64)
    out = np.zeros((n, max_runs), np.uint32)
    n_runs = np.zeros(n, np.int32)
    rc = lib.rle_ops(
        _ptr(ops, ctypes.c_uint8), n, smax,
        _ptr(fin_i, ctypes.c_int32), _ptr(fin_j, ctypes.c_int32),
        _ptr(lens64, ctypes.c_int64), _ptr(out, ctypes.c_uint32),
        max_runs, _ptr(n_runs, ctypes.c_int32),
    )
    if rc:
        return None
    return [
        [(int(v) >> 4, int(v) & 0xF) for v in out[r, : n_runs[r]]]
        for r in range(n)
    ]


def update_extra_scan(qseq: np.ndarray, tseq: np.ndarray, cigar: list,
                      a: int, b: int, q: int, e: int, log_gap: bool):
    """mm_update_extra's rescoring scan (align.c:259-318) in C.

    Returns (blen, mlen, n_ambi, dp_max, qoff, toff) or None when the
    native library is unavailable."""
    if lib is None:
        return None
    packed = np.fromiter(
        ((l << 4) | op for l, op in cigar), np.uint32, len(cigar)
    )
    qv = np.ascontiguousarray(qseq, np.uint8)
    tv = np.ascontiguousarray(tseq, np.uint8)
    out = np.zeros(6, np.int64)
    lib.update_extra_scan(
        _ptr(qv, ctypes.c_uint8), _ptr(tv, ctypes.c_uint8),
        _ptr(packed, ctypes.c_uint32), len(cigar),
        a, b, q, e, 1 if log_gap else 0, _ptr(out, ctypes.c_int64),
    )
    return tuple(int(x) for x in out)


def update_extra_batch(jobs: list, a: int, b: int, q: int, e: int,
                       log_gap: bool):
    """One C call for many update_extra scans. ``jobs`` is a list of
    (qwin u8, twin u8, cigar [(len, op), ...]); returns an [n, 6] i64
    array (blen, mlen, n_ambi, dp_max, qoff, toff) or None without the
    native library."""
    if lib is None or not jobs:
        return None
    n = len(jobs)
    qoffs = np.zeros(n, np.int64)
    toffs = np.zeros(n, np.int64)
    cigoffs = np.zeros(n, np.int64)
    cign = np.zeros(n, np.int64)
    qt = tt = ct = 0
    for i, (qw, tw, cig) in enumerate(jobs):
        qoffs[i], toffs[i], cigoffs[i], cign[i] = qt, tt, ct, len(cig)
        qt += len(qw)
        tt += len(tw)
        ct += len(cig)
    qbuf = np.empty(max(qt, 1), np.uint8)
    tbuf = np.empty(max(tt, 1), np.uint8)
    cigbuf = np.empty(max(ct, 1), np.uint32)
    for i, (qw, tw, cig) in enumerate(jobs):
        qbuf[qoffs[i] : qoffs[i] + len(qw)] = qw
        tbuf[toffs[i] : toffs[i] + len(tw)] = tw
        o = cigoffs[i]
        for j, (l, op) in enumerate(cig):
            cigbuf[o + j] = (l << 4) | op
    out = np.zeros((n, 6), np.int64)
    lib.update_extra_batch(
        _ptr(qbuf, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        _ptr(tbuf, ctypes.c_uint8), _ptr(toffs, ctypes.c_int64),
        _ptr(cigbuf, ctypes.c_uint32), _ptr(cigoffs, ctypes.c_int64),
        _ptr(cign, ctypes.c_int64), n, a, b, q, e,
        1 if log_gap else 0, _ptr(out, ctypes.c_int64),
    )
    return out


def update_extra_full_batch(jobs: list, a: int, b: int, q: int, e: int,
                            log_gap: bool):
    """Fused mm_fix_cigar + rescoring scan, one C call per batch. ``jobs``
    holds (qwin u8, twin u8, cigar) with the UNSHIFTED windows; returns
    (out [n, 8] i64, cigars) where out rows are (blen, mlen, n_ambi,
    dp_max, qoff, toff, lead_op, lead_len) and cigars are the fixed
    (len, op) lists. None without the native library."""
    if lib is None or not jobs:
        return None
    n = len(jobs)
    qoffs = np.zeros(n, np.int64)
    toffs = np.zeros(n, np.int64)
    cigoffs = np.zeros(n, np.int64)
    cign = np.zeros(n, np.int64)
    qt = tt = ct = 0
    for i, (qw, tw, cig) in enumerate(jobs):
        qoffs[i], toffs[i], cigoffs[i], cign[i] = qt, tt, ct, len(cig)
        qt += len(qw)
        tt += len(tw)
        ct += len(cig)
    qbuf = np.empty(max(qt, 1), np.uint8)
    tbuf = np.empty(max(tt, 1), np.uint8)
    cigbuf = np.empty(max(ct, 1), np.uint32)
    for i, (qw, tw, cig) in enumerate(jobs):
        qbuf[qoffs[i] : qoffs[i] + len(qw)] = qw
        tbuf[toffs[i] : toffs[i] + len(tw)] = tw
        o = cigoffs[i]
        for j, (l, op) in enumerate(cig):
            cigbuf[o + j] = (l << 4) | op
    out = np.zeros((n, 8), np.int64)
    lib.update_extra_full_batch(
        _ptr(qbuf, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        _ptr(tbuf, ctypes.c_uint8), _ptr(toffs, ctypes.c_int64),
        _ptr(cigbuf, ctypes.c_uint32), _ptr(cigoffs, ctypes.c_int64),
        _ptr(cign, ctypes.c_int64), n, a, b, q, e,
        1 if log_gap else 0, _ptr(out, ctypes.c_int64),
    )
    cigars = [
        [(int(v) >> 4, int(v) & 0xF)
         for v in cigbuf[cigoffs[i] : cigoffs[i] + cign[i]]]
        for i in range(n)
    ]
    return out, cigars


def _blob(strs: list[str]) -> tuple[bytes, np.ndarray]:
    # offsets must be BYTE offsets. Fast path: one join + one encode, with
    # character-count offsets — valid iff the blob is pure ASCII (byte len
    # == char len), which reads/names always are in practice. A non-ASCII
    # char would desynchronize offsets, so fall back to per-string encode
    # when the lengths disagree.
    joined = "".join(strs)
    blob = joined.encode()
    offs = np.zeros(len(strs) + 1, np.int64)
    if len(blob) == len(joined):
        np.cumsum([len(s) for s in strs], out=offs[1:])
        return blob, offs
    bs = [s.encode() for s in strs]
    np.cumsum([len(b) for b in bs], out=offs[1:])
    return b"".join(bs), offs


def make_sr_blobs(names, seqs, quals):
    """Prebuild the (name, seq, qual) byte blobs + offsets for
    sr_finish_batch — callable off the blocking finish path."""
    return (*_blob(names), *_blob(seqs), *_blob(quals))


def sr_finish_batch(
    meta: np.ndarray,  # [B, F] int32 (fused step meta, on host)
    ops: np.ndarray,  # [N2, OB] uint8 compacted 2-bit op streams
    K: int,
    Lmax: int,
    codes: np.ndarray,  # [B, Lmax] uint8
    lens: np.ndarray,  # [B] int64
    names: list[str],
    seqs: list[str],
    quals: list[str],  # "" for missing
    ref_codes: np.ndarray,  # uint8 flat
    ref_seq_offs: np.ndarray,  # [n_ref] int64
    ref_names_blob: bytes,
    ref_name_offs: np.ndarray,  # [n_ref+1] int64
    a: int, b: int, q: int, e: int,
    min_dp_max: int, max_nb_sec: int,
    no_print_2nd: bool, softclip: bool, rep_len: int = 0,
    blobs=None,
):
    """Entire short-read host finish (regs + filters + SAM text) in one C
    call. Returns (sam_buffer bytes, rec_offs [B+1], done [B] u8) or None
    when the native library is unavailable.

    ``blobs`` — optional prebuilt make_sr_blobs(names, seqs, quals) result,
    letting callers build the string blobs while the device computes
    instead of on this blocking path."""
    if lib is None:
        return None
    B = meta.shape[0]
    meta = np.ascontiguousarray(meta, np.int32)
    ops = np.ascontiguousarray(ops, np.uint8)
    codes = np.ascontiguousarray(codes, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64)
    if blobs is not None:
        nblob, noffs, sblob, soffs, qblob, qoffs = blobs
    else:
        nblob, noffs = _blob(names)
        sblob, soffs = _blob(seqs)
        qblob, qoffs = _blob(quals)
    cap = int(
        noffs[-1] + 2 * soffs[-1] + qoffs[-1] + B * 448 + (1 << 16)
    )
    for _ in range(3):
        out = ctypes.create_string_buffer(cap)
        rec_offs = np.zeros(B + 1, np.int64)
        done = np.zeros(B, np.uint8)
        rc = lib.sr_finish_batch(
            _ptr(meta, ctypes.c_int32), _ptr(ops, ctypes.c_uint8),
            ops.shape[1], B, K, Lmax,
            _ptr(codes, ctypes.c_uint8), _ptr(lens, ctypes.c_int64),
            nblob, _ptr(noffs, ctypes.c_int64),
            sblob, _ptr(soffs, ctypes.c_int64),
            qblob, _ptr(qoffs, ctypes.c_int64),
            _ptr(np.ascontiguousarray(ref_codes, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(ref_seq_offs, np.int64), ctypes.c_int64),
            ref_names_blob, _ptr(ref_name_offs, ctypes.c_int64),
            a, b, q, e, min_dp_max, max_nb_sec,
            1 if no_print_2nd else 0, 1 if softclip else 0, rep_len,
            out, cap, _ptr(rec_offs, ctypes.c_int64),
            _ptr(done, ctypes.c_uint8),
        )
        if rc >= 0:
            return out.raw[:rc], rec_offs, done
        cap *= 4
    return None


def pe_finish_batch(
    meta: np.ndarray,  # [B, F] int32, B = 2*pairs (even R1 / odd R2)
    ops: np.ndarray,  # [N2, OB] uint8 compacted 2-bit op streams
    K: int,
    Lmax: int,
    codes: np.ndarray,  # [B, Lmax] uint8 MAPPING orientation
    lens: np.ndarray,  # [B] int64
    ref_codes: np.ndarray,
    ref_seq_offs: np.ndarray,
    ref_names_blob: bytes,
    ref_name_offs: np.ndarray,
    a: int, b: int, q: int, e: int,
    min_dp_max: int, max_nb_sec: int,
    no_print_2nd: bool, softclip: bool, rep_len: int,
    flip0: bool, flip1: bool,
    max_gap_ref: int, pe_bonus: int,
    blobs=None,
):
    """Entire paired-end host finish (regs + set_sam_params + mm_pair +
    flip-back + n_seg=2 SAM records) in one C call. ``blobs`` holds the
    ORIGINAL per-segment (name, seq, qual) byte blobs from make_sr_blobs.
    Returns (sam_buffer bytes, rec_offs [P+1] per pair, done [P] u8) or
    None when the native library is unavailable."""
    if lib is None or blobs is None:
        return None
    B = meta.shape[0]
    meta = np.ascontiguousarray(meta, np.int32)
    ops = np.ascontiguousarray(ops, np.uint8)
    codes = np.ascontiguousarray(codes, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64)
    nblob, noffs, sblob, soffs, qblob, qoffs = blobs
    cap = int(
        noffs[-1] + 2 * soffs[-1] + qoffs[-1] + B * 480 + (1 << 16)
    )
    P = B // 2
    for _ in range(3):
        out = ctypes.create_string_buffer(cap)
        rec_offs = np.zeros(P + 1, np.int64)
        done = np.zeros(P, np.uint8)
        rc = lib.pe_finish_batch(
            _ptr(meta, ctypes.c_int32), _ptr(ops, ctypes.c_uint8),
            ops.shape[1], B, K, Lmax,
            _ptr(codes, ctypes.c_uint8), _ptr(lens, ctypes.c_int64),
            nblob, _ptr(noffs, ctypes.c_int64),
            sblob, _ptr(soffs, ctypes.c_int64),
            qblob, _ptr(qoffs, ctypes.c_int64),
            _ptr(np.ascontiguousarray(ref_codes, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(ref_seq_offs, np.int64), ctypes.c_int64),
            ref_names_blob, _ptr(ref_name_offs, ctypes.c_int64),
            a, b, q, e, min_dp_max, max_nb_sec,
            1 if no_print_2nd else 0, 1 if softclip else 0, rep_len,
            1 if flip0 else 0, 1 if flip1 else 0, max_gap_ref, pe_bonus,
            out, cap, _ptr(rec_offs, ctypes.c_int64),
            _ptr(done, ctypes.c_uint8),
        )
        if rc >= 0:
            return out.raw[:rc], rec_offs, done
        cap *= 4
    return None


def extd2_approx(query, target, a: int, b: int, q: int, e: int,
                 q2: int, e2: int, w: int):
    """Scalar banded dual-affine DP (oracle/align.py::extd2 semantics for
    the APPROX_MAX + left-aligned + CIGAR configuration) in C. Returns
    (score, cigar list) or None when the native library is unavailable
    or the CIGAR overflowed."""
    if lib is None:
        return None
    qv = np.ascontiguousarray(query, np.uint8)
    tv = np.ascontiguousarray(target, np.uint8)
    max_cig = 2 * (len(qv) + len(tv)) + 16
    cig = np.zeros(max_cig, np.uint32)
    n_cig = np.zeros(1, np.int64)
    score = lib.extd2_approx(
        _ptr(qv, ctypes.c_uint8), len(qv), _ptr(tv, ctypes.c_uint8), len(tv),
        a, b, q, e, q2, e2, w,
        _ptr(cig, ctypes.c_uint32), max_cig, _ptr(n_cig, ctypes.c_int64),
    )
    if n_cig[0] < 0:
        return None
    return int(score), [(int(v) >> 4, int(v) & 0xF) for v in cig[: n_cig[0]]]
