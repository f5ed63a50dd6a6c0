"""Wrappers of the Hopper kernels in ``csrc/``: the DP (``extd2.cu``,
``extd2_fold.cu``, ``extd2_band.cu``) and the windowed backtrack
(``backtrack_band.cu``).

``extd2_batch`` is the one DP entry point and mirrors
``extd2_batch_pallas``: it takes the tensors of ``ops/dp.py::extd2_batch``.
With ``band_budget`` set and a lane window narrower than round128(Lt)
(``ops/dp_band.py::window_geometry``) it returns what
``ops/dp_band.py::extd2_band`` returns; with ``fold=True`` what
``ops/dp_fold.py::extd2_fold`` returns (the raw folded dirs layout);
otherwise what ``ops/dp.py::extd2_batch`` returns. ``backtrack_band`` walks
the dirs of any of the three layouts: the short-read step's (full width or
folded) and the long-read buckets' (banded or full width).

For CUDA tensors each launches its hand-written kernel (built with ``nvcc``
for ``sm_90a`` at first use and bound with ctypes); for CPU tensors it runs
the plain torch version. There is no fallback from one to the other: a CUDA
call either launches or raises. ``launches``, ``fold_launches``,
``band_launches`` and ``backtrack_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from gdiet_tpu_torch.ops import LaunchCount
from gdiet_tpu_torch.ops import dp, dp_band, dp_fold

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
# one shared library per csrc/<name>.cu (vote_scan's wrapper: ops/vote.py)
KERNELS = ("extd2", "extd2_fold", "extd2_band", "backtrack_band", "vote_scan")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = LaunchCount()
fold_launches = LaunchCount()
band_launches = LaunchCount()
backtrack_launches = LaunchCount()
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA DP "
                           "kernels are built from csrc/ at first use")
    return found


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}_{tag}.so"


def build_all(names=KERNELS, verbose: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` for each name into ``_build/`` (cached by
    source hash), one ``nvcc`` per source, all started together. Returns
    {name: (library path, seconds spent compiling, compiler output)}."""
    out, procs = {}, {}
    for name in names:
        src, so = _target(name)
        if so.exists():
            out[name] = (so, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, so)
    failed = []
    for name, (proc, t0, tmp, so) in procs.items():  # wait for every nvcc
        log, _ = proc.communicate(timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        out[name] = (so, secs, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# each library's C entry point and its arguments
ENTRIES = {
    "extd2": ("gdiet_extd2", [_P] * 7 + [_I64] * 5 + [_I] * 8 + [_P]),
    "extd2_fold": ("gdiet_extd2_fold", [_P] * 7 + [_I64] * 8 + [_I] * 8 + [_P]),
    "extd2_band": ("gdiet_extd2_band", [_P] * 7 + [_I64] * 6 + [_I] * 10 + [_P]),
    "backtrack_band": ("gdiet_backtrack_band", [_P] * 7 + [_I64] * 8 + [_I] * 2 + [_P]),
    "vote_scan": ("gdiet_vote_scan", [_P] * 18 + [_I64] * 2 + [_I] + [_P]),
}


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        so, _, _ = build_all([name])[name]
        lib = ctypes.CDLL(str(so))
        entry, argtypes = ENTRIES[name]
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _libs[name] = lib
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"extd2: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"extd2: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"extd2: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"extd2: {name} is not contiguous")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def extd2_batch(query, target, lens, band, params, Lmax: int, tlens=None,
                Lt: int | None = None, fold: bool = False,
                band_budget: int | None = None, unroll: int = dp_band.DP_UNROLL):
    """Banded dual affine-gap extension of N (query, target) windows.

    query [N, Lmax] u8, target [N, Lt] u8, lens/band/tlens [N] i32 (qlen <=
    Lmax, tlen <= Lt). With the lane window engaged (``band_budget`` set
    and ``window_geometry(band_budget, round128(Lt), unroll)`` not None):
    (score [N] i32, dirs [N, R, WB] u8, offs, off_ends [N, R] i32) as
    ops/dp_band.py returns them. Else ``fold=False``: (score, dirs [N,
    Lmax+Lt-1, round16(Lt)], offs, off_ends) as ops/dp.py returns them;
    ``fold=True``: (score [N], dirs [(C+1)*H, Nrows, T] u8, offs, off_ends
    [N, 2H]) as ops/dp_fold.py returns them. The window and the fold
    exclude each other, as in extd2_batch_pallas."""
    if Lt is None:
        Lt = Lmax
    windowed = (band_budget is not None and dp_band.window_geometry(
        band_budget, dp.round_up(Lt, 128), unroll) is not None)
    if windowed and fold:
        raise ValueError("extd2: the banded lane window and the fold exclude each other")
    if query.device.type == "cpu":
        if windowed:
            return dp_band.extd2_band(query, target, lens, band, params, Lmax,
                                      lens if tlens is None else tlens, Lt,
                                      band_budget, unroll)
        plain = dp_fold.extd2_fold if fold else dp.extd2_batch
        return plain(query, target, lens, band, params, Lmax, tlens, Lt)
    if query.device.type != "cuda":
        raise ValueError(f"extd2: unsupported device {query.device}")
    N = query.shape[0]
    dev = query.device
    _check("query", query, torch.uint8, (N, Lmax), dev)
    _check("target", target, torch.uint8, (N, Lt), dev)
    _check("lens", lens, torch.int32, (N,), dev)
    _check("band", band, torch.int32, (N,), dev)
    if tlens is not None:
        _check("tlens", tlens, torch.int32, (N,), dev)
    ptrs = (query.data_ptr(), target.data_ptr(), lens.data_ptr(),
            tlens.data_ptr() if tlens is not None else None, band.data_ptr())
    scoring = dp.derive_scoring(params)
    if windowed:
        return _extd2_band(query, target, lens, tlens if tlens is not None else lens,
                           band, scoring, Lmax, Lt, band_budget, unroll)
    if fold:
        H, T, Tn = dp_fold.fold_geometry(Lmax, Lt)
        _, Nrows, C = dp_fold.fold_split(N, T)
        score = torch.empty(((C + 1) * Nrows,), dtype=torch.int32, device=dev)
        dirs = torch.empty(((C + 1) * H, Nrows, T), dtype=torch.uint8, device=dev)
        lib = _library("extd2_fold")
        with torch.cuda.device(dev):
            rc = lib.gdiet_extd2_fold(*ptrs, score.data_ptr(), dirs.data_ptr(),
                                      N, Lmax, Lt, T, Tn, H, Nrows, C,
                                      *scoring, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"extd2_fold kernel launch failed: CUDA error {rc}")
        fold_launches.n += 1
        offs, off_ends = dp.band_geometry(lens, tlens, band, 2 * H, Tn)
        return score[Nrows:][:N], dirs, offs, off_ends
    T = dp.round16(Lt)
    R = Lmax + Lt - 1
    score = torch.empty((N,), dtype=torch.int32, device=dev)
    dirs = torch.empty((N, R, T), dtype=torch.uint8, device=dev)
    if N:
        lib = _library("extd2")
        with torch.cuda.device(dev):
            rc = lib.gdiet_extd2(*ptrs, score.data_ptr(), dirs.data_ptr(),
                                 N, Lmax, Lt, T, R, *scoring, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"extd2 kernel launch failed: CUDA error {rc}")
        launches.n += 1
    offs, off_ends = dp.band_geometry(lens, tlens, band, R, T)
    return score, dirs, offs, off_ends


def _extd2_band(query, target, lens, tlens, band, scoring, Lmax: int, Lt: int,
                band_budget: int, unroll: int):
    """Launch ``csrc/extd2_band.cu`` (the checks are extd2_batch's)."""
    T, R, WB = dp_band.band_shape(Lmax, Lt, band_budget, unroll)
    N = query.shape[0]
    dev = query.device
    score = torch.empty((N,), dtype=torch.int32, device=dev)
    dirs = torch.empty((N, R, WB), dtype=torch.uint8, device=dev)
    if N:
        lib = _library("extd2_band")
        with torch.cuda.device(dev):
            rc = lib.gdiet_extd2_band(
                query.data_ptr(), target.data_ptr(), lens.data_ptr(),
                tlens.data_ptr(), band.data_ptr(), score.data_ptr(),
                dirs.data_ptr(), N, Lmax, Lt, T, R, WB, band_budget, unroll,
                *scoring, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"extd2_band kernel launch failed: CUDA error {rc}")
        band_launches.n += 1
    offs, off_ends = dp.band_geometry(lens, tlens, band, R, T)
    return score, dirs, offs, off_ends


def backtrack_band(dirs, lens, tlens, band, Lmax: int, Lt: int,
                   band_budget: int | None = None, unroll: int = dp_band.DP_UNROLL,
                   fold: bool = False):
    """Backtrack of the dirs of one DP call, in its layout: the raw folded
    layout of ``extd2_fold`` ([(C+1)*H, Nrows, T], N taken from ``lens``)
    with ``fold=True``; else the windowed layout of ``extd2_band`` when
    ``band_budget``'s window engages at (Lt, unroll); else the full width
    of ``extd2`` ([N, R, round16(Lt)]). Returns (ops [N, Rpad] u8, fin_i
    [N] i32, fin_j [N] i32) as ``pipeline/device_step.py::backtrack_antidiag``
    does, which is what CPU tensors run; CUDA tensors launch
    ``csrc/backtrack_band.cu``."""
    if dirs.device.type == "cpu":
        from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

        return backtrack_antidiag(dirs, lens, band, Lmax, tlens=tlens, Lt=Lt, fold=fold,
                                  band_budget=band_budget, unroll=unroll)
    if dirs.device.type != "cuda":
        raise ValueError(f"backtrack_band: unsupported device {dirs.device}")
    N = lens.shape[0]
    dev = dirs.device
    T = dp.round_up(Lt, 128)  # the band limits' lane range
    WB = None
    if fold:
        if band_budget is not None:
            raise ValueError("backtrack_band: the banded lane window and the fold "
                             "exclude each other")
        H, Wd, _ = dp_fold.fold_geometry(Lmax, Lt)
        _, Nrows, C = dp_fold.fold_split(N, Wd)
        shape, R = ((C + 1) * H, Nrows, Wd), 2 * H
    else:
        WB = (dp_band.window_geometry(band_budget, T, unroll)
              if band_budget is not None else None)
        if WB is None:
            Wd, R = dp.round16(Lt), Lmax + Lt - 1
        else:
            Wd, R = WB, dp_band.band_shape(Lmax, Lt, band_budget, unroll)[1]
        shape, H, Nrows = (N, R, Wd), R, 1
    _check("dirs", dirs, torch.uint8, shape, dev)
    for name, t in (("lens", lens), ("tlens", tlens), ("band", band)):
        _check(name, t, torch.int32, (N,), dev)
    if dirs.data_ptr() % 16:
        raise ValueError("backtrack_band: dirs must be 16-byte aligned")
    Rpad = dp.round_up(R, 8)
    ops = torch.empty((N, Rpad), dtype=torch.uint8, device=dev)
    fin_i = torch.empty((N,), dtype=torch.int32, device=dev)
    fin_j = torch.empty((N,), dtype=torch.int32, device=dev)
    if N:
        lib = _library("backtrack_band")
        with torch.cuda.device(dev):
            rc = lib.gdiet_backtrack_band(
                dirs.data_ptr(), lens.data_ptr(), tlens.data_ptr(),
                band.data_ptr(), ops.data_ptr(), fin_i.data_ptr(),
                fin_j.data_ptr(), N, R, Wd, T, Rpad, WB or 0, H, Nrows,
                band_budget or 0, unroll, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"backtrack_band kernel launch failed: CUDA error {rc}")
        backtrack_launches.n += 1
    return ops, fin_i, fin_j
