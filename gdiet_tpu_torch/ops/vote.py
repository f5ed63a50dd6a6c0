"""Wrapper of the short-read vote-scan kernel (``csrc/vote_scan.cu``).

``vote_scan`` takes the stream of ``pipeline/device_step.py::vote_scan``
(the plain loop, one batch of small torch ops per column) and returns the
same 11 outputs. For CUDA tensors it launches the hand-written kernel
(built with ``nvcc`` for ``sm_90a`` at first use by ``ops/extd2.py``'s
``build_all`` and bound with ctypes); for CPU tensors it runs the plain loop.
There is no fallback from one to the other: a CUDA call launches or
raises. ``launches`` counts the kernel's launches, ``device_step.vote_calls``
the plain loop's calls.
"""

from __future__ import annotations

import torch

from gdiet_tpu_torch.ops import LaunchCount, extd2

launches = LaunchCount()

OUTPUTS = ("k_score", "k_target", "k_fq", "k_lq", "k_str", "out_len",
           "r_score", "r_target", "r_fq", "r_lq", "r_str")


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"vote_scan: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"vote_scan: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"vote_scan: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"vote_scan: {name} is not contiguous")


def vote_scan(keys, qpos, valid, strand, vt_distance, vt_threshold,
              vt_rec_threshold, K: int) -> dict:
    """Vote over the hit stream of each read (map.c:447-584).

    keys [B, M] int64 (uint64 bit patterns, compared unsigned), qpos [B, M]
    int32, valid [B, M] bool, strand [M] int32 (the strand of each column),
    vt_distance [B] int64, vt_threshold and vt_rec_threshold [B] int32.
    Returns {k_score, k_fq, k_lq, k_str: [B, K] int32, k_target: [B, K]
    int64, out_len, r_score, r_fq, r_lq, r_str: [B] int32, r_target: [B]
    int64}."""
    if keys.device.type == "cpu":
        from gdiet_tpu_torch.pipeline.device_step import vote_scan as plain

        return plain(keys, qpos, valid, strand, vt_distance, vt_threshold,
                     vt_rec_threshold, K)
    if keys.device.type != "cuda":
        raise ValueError(f"vote_scan: unsupported device {keys.device}")
    if K < 1:
        raise ValueError(f"vote_scan: K = {K}, expected >= 1")
    B, M = keys.shape
    dev = keys.device
    _check("keys", keys, torch.int64, (B, M), dev)
    _check("qpos", qpos, torch.int32, (B, M), dev)
    _check("valid", valid, torch.bool, (B, M), dev)
    _check("strand", strand, torch.int32, (M,), dev)
    _check("vt_distance", vt_distance, torch.int64, (B,), dev)
    _check("vt_threshold", vt_threshold, torch.int32, (B,), dev)
    _check("vt_rec_threshold", vt_rec_threshold, torch.int32, (B,), dev)
    out = {}
    for name in OUTPUTS:
        shape = (B, K) if name.startswith("k_") else (B,)
        dtype = torch.int64 if name.endswith("target") else torch.int32
        out[name] = torch.empty(shape, dtype=dtype, device=dev)
    if B:
        lib = extd2._library("vote_scan")
        with torch.cuda.device(dev):
            rc = lib.gdiet_vote_scan(
                keys.data_ptr(), qpos.data_ptr(), valid.data_ptr(),
                strand.data_ptr(), vt_distance.data_ptr(), vt_threshold.data_ptr(),
                vt_rec_threshold.data_ptr(), *(out[n].data_ptr() for n in OUTPUTS),
                B, M, K, extd2._stream(dev))
        if rc != 0:
            raise RuntimeError(f"vote_scan kernel launch failed: CUDA error {rc}")
        launches.n += 1
    return out
