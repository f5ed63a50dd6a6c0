"""Wrappers of the Hopper DP kernels ``csrc/extd2.cu`` and
``csrc/extd2_fold.cu``.

``extd2_batch`` takes the tensors of ``ops/dp.py::extd2_batch``. With
``fold=False`` it returns what that function returns; with ``fold=True``
what ``ops/dp_fold.py::extd2_fold`` returns (the raw folded dirs layout),
mirroring ``extd2_batch_pallas(..., fold=...)``. For CUDA tensors it
launches the hand-written kernel (built with ``nvcc`` for ``sm_90a`` at
first use and bound with ctypes); for CPU tensors it runs the plain torch
version. There is no fallback from one to the other: a CUDA call either
launches or raises. ``launches`` and ``fold_launches`` count kernel
launches.
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
from gdiet_tpu_torch.ops import dp, dp_fold

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
KERNELS = ("extd2", "extd2_fold")  # one shared library per csrc/<name>.cu
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = LaunchCount()
fold_launches = LaunchCount()
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


def _library(name: str, entry: str, argtypes: list) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        so, _, _ = build_all([name])[name]
        lib = ctypes.CDLL(str(so))
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


def extd2_batch(query, target, lens, band, params, Lmax: int, tlens=None,
                Lt: int | None = None, fold: bool = False):
    """Banded dual affine-gap extension of N (query, target) windows.

    query [N, Lmax] u8, target [N, Lt] u8, lens/band/tlens [N] i32 (qlen <=
    Lmax, tlen <= Lt). ``fold=False``: (score [N] i32, dirs [N, Lmax+Lt-1,
    round16(Lt)] u8, offs, off_ends [N, R] i32) as ops/dp.py returns them.
    ``fold=True``: (score [N], dirs [(C+1)*H, Nrows, T] u8, offs, off_ends
    [N, 2H]) as ops/dp_fold.py returns them."""
    if query.device.type == "cpu":
        plain = dp_fold.extd2_fold if fold else dp.extd2_batch
        return plain(query, target, lens, band, params, Lmax, tlens, Lt)
    if query.device.type != "cuda":
        raise ValueError(f"extd2: unsupported device {query.device}")
    if Lt is None:
        Lt = Lmax
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
    if fold:
        H, T, Tn = dp_fold.fold_geometry(Lmax, Lt)
        _, Nrows, C = dp_fold.fold_split(N, T)
        score = torch.empty(((C + 1) * Nrows,), dtype=torch.int32, device=dev)
        dirs = torch.empty(((C + 1) * H, Nrows, T), dtype=torch.uint8, device=dev)
        lib = _library("extd2_fold", "gdiet_extd2_fold",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 8
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gdiet_extd2_fold(*ptrs, score.data_ptr(), dirs.data_ptr(),
                                      N, Lmax, Lt, T, Tn, H, Nrows, C,
                                      *scoring, stream)
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
        lib = _library("extd2", "gdiet_extd2",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gdiet_extd2(*ptrs, score.data_ptr(), dirs.data_ptr(),
                                 N, Lmax, Lt, T, R, *scoring, stream)
        if rc != 0:
            raise RuntimeError(f"extd2 kernel launch failed: CUDA error {rc}")
        launches.n += 1
    offs, off_ends = dp.band_geometry(lens, tlens, band, R, T)
    return score, dirs, offs, off_ends
