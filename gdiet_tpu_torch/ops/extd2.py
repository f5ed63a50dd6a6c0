"""Wrapper of the Hopper DP kernel ``csrc/extd2.cu``.

``extd2_batch`` takes the tensors of ``ops/dp.py::extd2_batch`` and returns
the same (score, dirs, offs, off_ends). For CUDA tensors it launches the
hand-written kernel (built with ``nvcc`` for ``sm_90a`` at first use and
bound with ctypes); for CPU tensors it runs the plain torch version. There
is no fallback from one to the other: a CUDA call either launches or raises.
``launches`` counts kernel launches.
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
from gdiet_tpu_torch.ops import dp

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "extd2.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = LaunchCount()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA DP "
                           "kernel is built from csrc/extd2.cu at first use")
    return found


def build(verbose: bool = False) -> tuple[pathlib.Path, float, str]:
    """Compile ``csrc/extd2.cu`` into ``_build/`` (cached by source hash).
    Returns (library path, seconds spent compiling, compiler output)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"extd2_{tag}.so"
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so, dt, res.stdout + res.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        lib.gdiet_extd2.restype = ctypes.c_int
        lib.gdiet_extd2.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_void_p]
        )
        _lib = lib
    return _lib


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
                Lt: int | None = None):
    """Banded dual affine-gap extension of N (query, target) windows.

    query [N, Lmax] u8, target [N, Lt] u8, lens/band/tlens [N] i32 (qlen <=
    Lmax, tlen <= Lt). Returns (score [N] i32, dirs [N, Lmax+Lt-1,
    round16(Lt)] u8, offs, off_ends [N, R] i32) as ops/dp.py does."""
    if query.device.type == "cpu":
        return dp.extd2_batch(query, target, lens, band, params, Lmax, tlens, Lt)
    if query.device.type != "cuda":
        raise ValueError(f"extd2: unsupported device {query.device}")
    if Lt is None:
        Lt = Lmax
    N = query.shape[0]
    T = dp.round16(Lt)
    R = Lmax + Lt - 1
    dev = query.device
    _check("query", query, torch.uint8, (N, Lmax), dev)
    _check("target", target, torch.uint8, (N, Lt), dev)
    _check("lens", lens, torch.int32, (N,), dev)
    _check("band", band, torch.int32, (N,), dev)
    if tlens is not None:
        _check("tlens", tlens, torch.int32, (N,), dev)
    score = torch.empty((N,), dtype=torch.int32, device=dev)
    dirs = torch.empty((N, R, T), dtype=torch.uint8, device=dev)
    if N:
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gdiet_extd2(
                query.data_ptr(), target.data_ptr(), lens.data_ptr(),
                tlens.data_ptr() if tlens is not None else None,
                band.data_ptr(), score.data_ptr(), dirs.data_ptr(),
                N, Lmax, Lt, T, R, *dp.derive_scoring(params), stream,
            )
        if rc != 0:
            raise RuntimeError(f"extd2 kernel launch failed: CUDA error {rc}")
        launches.n += 1
    offs, off_ends = dp.band_geometry(lens, tlens, band, R, T)
    return score, dirs, offs, off_ends
