"""Wrappers of the vote kernels: the short-read vote (``csrc/vote_scan.cu``)
and the long-read round-1 and round-2 votes (``csrc/vote_lr.cu``).

Each takes the two strand halves of a hit stream in place, as
``device_step.collect_hits`` returns them (``fk, fq, fok, rk, rq, rok``,
[B, A] each; a column slice such as the long-read front's ``[:, :C]`` is
taken as a view). The plain versions walk their concatenation fwd |
barrier | rev | barrier, whose barrier columns are invalid; the kernels
read the halves where they lie.

For CUDA tensors each launches its hand-written kernel (built with
``nvcc`` for ``sm_90a`` at first use by ``ops/extd2.py``'s ``build_all``
and bound with ctypes); for CPU tensors it runs the plain version on the
concatenated stream. There is no fallback from one to the other: a CUDA
call launches or raises. ``launches`` counts ``vote_scan.cu``'s launches,
``lr_launches`` those of ``vote_lr.cu`` (both entry points);
``device_step.vote_calls`` and ``lr_step.vote_calls`` count the plain
versions' calls.

Precondition of every entry point: in each half of each row the valid
columns come first. The hit collection's streams meet it: each strand is
sorted by key (``u64.argsort_u64``), an invalid hit's key is U64_MAX and a
valid key (chrom << 32 | position, chrom a reference index) is smaller.
The kernels stop reading a half after its last valid column, and the plain
long-read loops visit only the columns ``lr_step._stream_columns`` gives;
on a stream that breaks it their results are undefined. (The plain
short-read loop walks every column and needs no precondition.)
"""

from __future__ import annotations

import torch

from gdiet_tpu_torch.ops import LaunchCount, extd2

launches = LaunchCount()
lr_launches = LaunchCount()

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
    [B] int32, r_target: [B] int64}, what ``device_step.vote_scan`` returns
    for the concatenated stream."""
    if fk.device.type == "cpu":
        from gdiet_tpu_torch.pipeline.device_step import vote_scan as plain

        return plain(*concat_stream(fk, fq, fok, rk, rq, rok), vt_distance,
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
    ``lr_step._vote_scan_lr`` returns for the concatenated stream."""
    if fk.device.type == "cpu":
        from gdiet_tpu_torch.pipeline import lr_step

        keys, qv, okv, strand = concat_stream(fk, fq, fok, rk, rq, rok)
        return lr_step._vote_scan_lr(keys, qv, okv, strand.tolist(), extracted,
                                     vt_distance, cov_thr, K,
                                     lr_step._stream_columns(fok, rok))
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
    int32 block ``lr_step.vote2_packed_pair`` returns for the concatenated
    stream."""
    if fk.device.type == "cpu":
        from gdiet_tpu_torch.pipeline import lr_step

        keys, qv, okv, strand = concat_stream(fk, fq, fok, rk, rq, rok)
        return lr_step.vote2_packed_pair(keys, qv, okv, strand.tolist(), extracted,
                                         vt_distance, lo1, hi1, lo2, hi2,
                                         lr_step._stream_columns(fok, rok))
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
