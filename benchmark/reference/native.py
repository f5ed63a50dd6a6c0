"""ctypes binding of the reference's own C routines (``gdiet_native.c``
beside this file), built with ``cc`` at first use into the benchmark's
``_build/`` directory (cached by source hash).

Exposes the three calls the frozen oracle makes (``extd2_approx``,
``update_extra_scan``, ``update_extra_full_batch``) and
``set_saturation``, which the control uses. ``lib`` is looked up lazily
(module ``__getattr__``), so importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).parent / "gdiet_native.c"
BUILD = pathlib.Path(__file__).resolve().parent.parent / "_build"
_lib = None
_lib_lock = threading.Lock()

_P8, _P32, _P64 = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32),
                   ctypes.POINTER(ctypes.c_int64))
_I64 = ctypes.c_int64


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lib_lock:  # the check's threads may all make the first call
            if _lib is None:
                _lib = _build()
    return _lib


def _build() -> ctypes.CDLL:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD / f"ref_native_{tag}.so"
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["cc", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.ref_set_saturation.restype = None
    lib.ref_set_saturation.argtypes = [ctypes.c_int32]
    lib.update_extra_full_batch.restype = None
    lib.update_extra_full_batch.argtypes = [
        _P8, _P64, _P8, _P64, _P32, _P64, _P64, _I64,
        _I64, _I64, _I64, _I64, ctypes.c_int, _P64]
    lib.update_extra_scan.restype = None
    lib.update_extra_scan.argtypes = [
        _P8, _P8, _P32, _I64, _I64, _I64, _I64, _I64, ctypes.c_int, _P64]
    lib.extd2_approx.restype = ctypes.c_int64
    lib.extd2_approx.argtypes = [
        _P8, _I64, _P8, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _P32, _I64, _P64]
    return lib


def __getattr__(name):
    if name == "lib":
        return _load()
    raise AttributeError(name)


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def set_saturation(m: int) -> None:
    """Clamp the DP's lanes and running score to [-m-1, m]; 0 is exact."""
    _load().ref_set_saturation(int(m))


def update_extra_scan(qseq: np.ndarray, tseq: np.ndarray, cigar: list,
                      a: int, b: int, q: int, e: int, log_gap: bool):
    """mm_update_extra's rescoring scan: (blen, mlen, n_ambi, dp_max,
    qoff, toff)."""
    packed = np.fromiter(((l << 4) | op for l, op in cigar), np.uint32, len(cigar))
    qv = np.ascontiguousarray(qseq, np.uint8)
    tv = np.ascontiguousarray(tseq, np.uint8)
    out = np.zeros(6, np.int64)
    _load().update_extra_scan(
        _ptr(qv, ctypes.c_uint8), _ptr(tv, ctypes.c_uint8),
        _ptr(packed, ctypes.c_uint32), len(cigar), a, b, q, e,
        1 if log_gap else 0, _ptr(out, ctypes.c_int64))
    return tuple(int(x) for x in out)


def update_extra_full_batch(jobs: list, a: int, b: int, q: int, e: int,
                            log_gap: bool):
    """Fused mm_fix_cigar + rescoring scan over (qwin, twin, cigar) jobs:
    (out [n, 8] i64, fixed cigars), None for no jobs."""
    if not jobs:
        return None
    n = len(jobs)
    qoffs, toffs, cigoffs, cign = (np.zeros(n, np.int64) for _ in range(4))
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
        qbuf[qoffs[i]: qoffs[i] + len(qw)] = qw
        tbuf[toffs[i]: toffs[i] + len(tw)] = tw
        o = cigoffs[i]
        for j, (l, op) in enumerate(cig):
            cigbuf[o + j] = (l << 4) | op
    out = np.zeros((n, 8), np.int64)
    _load().update_extra_full_batch(
        _ptr(qbuf, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        _ptr(tbuf, ctypes.c_uint8), _ptr(toffs, ctypes.c_int64),
        _ptr(cigbuf, ctypes.c_uint32), _ptr(cigoffs, ctypes.c_int64),
        _ptr(cign, ctypes.c_int64), n, a, b, q, e,
        1 if log_gap else 0, _ptr(out, ctypes.c_int64))
    cigars = [[(int(v) >> 4, int(v) & 0xF)
               for v in cigbuf[cigoffs[i]: cigoffs[i] + cign[i]]] for i in range(n)]
    return out, cigars


def extd2_approx(query, target, a: int, b: int, q: int, e: int,
                 q2: int, e2: int, w: int):
    """The banded dual affine-gap DP: (score, cigar list), None when the
    CIGAR overflowed."""
    qv = np.ascontiguousarray(query, np.uint8)
    tv = np.ascontiguousarray(target, np.uint8)
    max_cig = 2 * (len(qv) + len(tv)) + 16
    cig = np.zeros(max_cig, np.uint32)
    n_cig = np.zeros(1, np.int64)
    score = _load().extd2_approx(
        _ptr(qv, ctypes.c_uint8), len(qv), _ptr(tv, ctypes.c_uint8), len(tv),
        a, b, q, e, q2, e2, w, _ptr(cig, ctypes.c_uint32), max_cig,
        _ptr(n_cig, ctypes.c_int64))
    if n_cig[0] < 0:
        return None
    return int(score), [(int(v) >> 4, int(v) & 0xF) for v in cig[: n_cig[0]]]
