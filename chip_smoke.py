#!/usr/bin/env python3
"""On-card smoke run of gdiet_tpu_torch (the PyTorch/CUDA port).

    python3 chip_smoke.py [--prev DIR]

Needs one CUDA GPU, the CUDA toolkit (nvcc) and a C compiler; imports no
JAX. Phases, each printing one line:

1. device/build: ``nvidia-smi`` name and power limit; the four CUDA kernels
   of the SR, PE and LR paths built from the checkout's sources, one
   ``nvcc`` per source started together (seconds and ``ptxas -v`` output
   per kernel).
2. kernel: the CUDA ``extd2`` DP kernel (one warp per row) against its
   plain torch version on the card at the short-read main-path shape (6,272
   rows, Lmax = Lt = 160, qlen 150, bands 150-200; seeded pairs with
   substitutions, indels, N bases and empty rows): scores, dirs, offs and
   off_ends bit-equal (tolerance: exact). Then the backtrack kernel on its
   dirs against the plain walk, exact. Prints the times (a kernel's as the
   median of 5 rounds of 10 launches, a plain version's as the better of 2
   runs), the bounds, us per wavefront step, the share of the bound, the
   backtrack's serial floor, ptxas registers/spills and the DPX
   instructions in the SASS (``cuobjdump -sass``, > 0).
3. kernel_fold: the folded ``extd2_fold`` kernel (four warps per kernel
   row) against its plain version on the same rows (576 kernel rows, 11
   passes + drain), then again on the rows the PE phase gives it per batch
   (5,120 rows of 4,096 pairs: 384 kernel rows, 14 passes): scores, every
   byte of the raw folded dirs, offs and off_ends bit-equal; the backtrack
   kernel on the folded dirs equal to the plain folded walk, and both to
   the plain walk of the unfolded kernel's dirs. Times, bounds and build
   facts as in phase 2.
   With ``--prev DIR`` (earlier sources of ``extd2.cu`` and
   ``extd2_fold.cu``): both kernels timed in turns against the earlier
   sources on the same inputs, outputs equal (phase ``prev``).
4. golden: ``tests/data`` fixtures (``golden.sam`` and ``golden2_*.sam`` for
   patterns 10, 1110, 11 and 110) mapped on the card through
   ``ShortReadMapper.map_stream_sam``; records must equal the reference
   binary's golden SAM byte for byte; the backtrack kernel launched and the
   plain walk never called.
5. main: the bench workload (2 Mbp genome, 150 bp reads at 0.5%
   substitutions, half reverse-complemented, bench.py's recipe) indexed on
   the card and mapped at the bench budgets, 1 warm-up + 4 timed batches of
   10,016 reads. Kernel launch counts (DP and backtrack) and the plain
   versions' call counts are reset just before and read just after: the
   kernels launched, the plain versions never called. Checks: >= 99% of
   the mapped primary records within 10 bp of where the reference places
   them (the simulated origin for forward reads; origin + k-1 for reverse
   reads, the reference's reverse-strand window), >= 90% of reads mapped,
   the first unmapped reads unmapped by the scalar oracle too, and the
   first 128 reads' SAM equal to the oracle's. One batch's per-phase device
   times; its DP inputs, as the step hands them to the DP kernel, through
   the kernel and the plain version, and its dirs through the backtrack
   kernel and the plain walk: exact.
6. golden_pe: the paired-end fixture (``ref_pe.fa``, ``reads_pe_1.fq`` +
   ``reads_pe_2.fq``) through the port's PE CLI on ``cuda`` with
   ``GDIET_DP_FOLD=1``: records equal the same run on ``cpu`` (the plain
   versions) and on ``cuda`` with the fold off, byte for byte, and the R1
   records match ``golden_pe_r1.sam`` as ``tests/test_pe_parity.py`` checks
   them. Both cuda runs launch the backtrack kernel and never the plain walk.
7. pe: the PE path at full width with ``GDIET_DP_FOLD=1``: FR pairs of 150
   bp ends (fragments of 250-500 bp, 0.5% substitutions) from the bench
   genome, 1 warm-up + 3 timed batches of 4,096 pairs at the JAX runtime's
   PE budgets. Launch counts are reset just before and read just after.
   Checks: >= 90% of pairs with both ends mapped, >= 99% of mapped primary
   records where the reference places them, the first 64 pairs equal to
   the oracle's PE finish, the first batch's SAM identical with the fold
   off, fold and backtrack launches > 0 and no plain-fold, unfolded or
   plain-backtrack call (none of the plain walk with the fold off either).
   The DP inputs of one batch, as the step hands them to the fold kernel,
   go through the kernel and the plain fold version once more, and the
   folded dirs through the backtrack kernel and the plain walk: exact.
8. kernel_band: the banded lane window kernel ``extd2_band`` against its
   plain version at the (2048, 3072) long-read bucket, 64 seeded windows
   (equal, mutated, indels, N codes, dead rows), at band 500 (WB 768) and
   1300 (WB 1,536), two lanes per thread: scores, every dirs byte, offs and
   off_ends exact, and ``backtrack_band`` on those dirs equal to the plain
   backtrack. The unwindowed (512, 1024) bucket of band 1000 through
   ``extd2`` (1,024 threads) and the backtrack kernel's full-width mode,
   exact. Then both kernels alone at (4096, 5120). Times as in phase 2, the
   plain versions one run each; every kernel's bound from this run's data.
   Also: us per wavefront step over the longest candidate's live steps, us
   per walk step of the longest walk and the walk's serial floor beside its
   bound; ptxas registers, static shared memory and spills of both
   kernels; the DPX instructions in the band kernel's SASS (``cuobjdump
   -sass``, > 0).
9. golden_lr: ``tests/data/ref_lr.fa`` + ``reads_lr.fq`` through the port's
   CLI on ``cuda`` with the HiFi and ONT arguments of
   ``tests/data/make_lr_fixtures.py``: records byte-equal to
   ``golden_lr_hifi.sam`` and ``golden_lr_ont.sam``.
10. lr: the HiFi path at full size: bench.py's ``gen_lr_reads`` recipe on
   the bench genome, its ``lr_stats`` options and mapper budgets, 1
   warm-up + 3 timed batches of 256 reads. Counts reset just before and
   read just after. Checks: >= 90% of reads mapped, the first 32 reads'
   SAM equal to the scalar oracle's, band and backtrack kernel launches > 0
   and no plain banded DP or plain backtrack call. One batch's per-phase
   times; one chunk's captured DP inputs (the smallest bucket) through the
   kernels and the plain versions once more, exact.

Then a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Any failed check exits non-zero before the last line is printed. Without a
GPU it exits non-zero at once.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

sys.modules.setdefault("jax", None)  # the port must not need JAX

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
GENOME_LEN, READ_LEN, SUB_RATE, SEED = 2_000_000, 150, 0.005, 20260816
BENCH_B, N_TIMED = 10016, 4
N_ORACLE, N_UNMAPPED_ORACLE = 128, 64
KERNEL_SHAPE = dict(N=6272, L=160, qlen=150)
KERNEL_ROUNDS, KERNEL_REPS = 5, 10  # rounds of 10 launches; the median is reported
PE_PAIRS, PE_TIMED, PE_ORACLE = 4096, 3, 64
FRAG_MIN, FRAG_MAX = 250, 500
PE_ARGS = ["-a", "-t", "1", "-x", "sr", "-Z", "10", "-W", "2", "-k", "21",
           "-w", "11", "-i", "2", "-N", "1", "-r", "0.05,150,200",
           "-n", "0.95,0.3", "-s", "100", "--AF_max_loc", "2", "-v", "1"]


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def sr_options(pattern: str = "10"):
    from gdiet_tpu_torch.config import options_for

    return options_for(
        "sr", pattern=pattern, max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
def phase_build() -> dict:
    """Every csrc/*.cu, all nvcc processes started together. Returns {name:
    (library, seconds, ptxas log)}."""
    from gdiet_tpu_torch.ops import extd2

    built = extd2.build_all(verbose=True)
    for name, (_, dt, log) in built.items():
        print(f"[build] {name}.cu: {dt:.2f} s\n{log.strip()}", flush=True)
    return built


def ptxas_info(log: str) -> dict:
    """Per kernel entry of nvcc's ``-Xptxas -v`` output: registers, static
    shared memory and spill bytes."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem"] = int(m[1])
    return out


def sass_vi_ops(so) -> dict:
    """Histogram of the VI* (vector-integer min/max) opcodes in a built
    library's SASS (``cuobjdump -sass``), and ``dpx``: those that are
    Hopper's DPX instructions (three-way max/min, fused add-max, max with
    relu), i.e. every VI* opcode other than the plain add VIADD and the
    plain two-way VIMNMX without relu. ``local_ops``: per kernel entry, the
    local-memory loads and stores (LDL, STL) in its SASS."""
    import collections
    import os
    import re
    import shutil

    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    tool = home / "bin" / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found (CUDA toolkit)")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    ops = collections.Counter()
    local = collections.Counter()
    pat = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?(VI[A-Z0-9_]*(?:\.[A-Z0-9_]+)*)")
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            local[fn] += 0
            continue
        m = pat.search(line)
        if m:
            ops[m.group(1)] += 1
        if re.search(r"\s(LDL|STL)(\.|\s)", line):
            local[fn] += 1
    dpx = sum(v for k, v in ops.items()
              if k.split(".")[0] not in ("VIADD", "VIMNMX") or "RELU" in k)
    return {"dpx": dpx, "vi_opcodes": dict(ops), "local_ops": dict(local)}


def dp_pairs(N: int, L: int, qlen: int, seed: int = 1):
    """Seeded DP rows: reads with ~0.5% substitutions, an indel in every
    fifth row, N bases in some, and empty rows."""
    rng = np.random.default_rng(seed)
    Q = np.zeros((N, L), np.uint8)
    T = np.zeros((N, L), np.uint8)
    lens = np.full(N, qlen, np.int32)
    band = rng.integers(150, 201, N).astype(np.int32)
    for i in range(N):
        t = rng.integers(0, 4, qlen + 8)
        q = t.copy()
        if i % 5 == 0:  # 1-3 base indel
            p, g = int(rng.integers(20, qlen - 20)), int(rng.integers(1, 4))
            q = (np.concatenate([q[:p], q[p + g:]]) if i % 10 == 0
                 else np.concatenate([q[:p], rng.integers(0, 4, g), q[p:]]))
        sub = rng.random(qlen) < SUB_RATE
        q = q[:qlen].copy()
        q[sub] = (q[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        if i % 17 == 0:
            q[int(rng.integers(0, qlen))] = 4
        if i % 23 == 0:
            t[int(rng.integers(0, qlen))] = 4
        Q[i, :qlen], T[i, :qlen] = q, t[:qlen]
    lens[::97] = 0
    return Q, T, lens, band


PARAMS = (2, 8, 12, 2, 24, 1)  # the sr preset's scoring


# bounds of the card (NVIDIA's H100 SXM data sheet): HBM bandwidth, and
# the int32 issue rate of 132 SMs x 64 INT32 lanes per clock x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per updated lane of the DP recurrence (the body of
# csrc/extd2*.cu: candidates, maxima, direction bits, state updates,
# substitution score) and per step of the backtrack walk
DP_OPS_PER_CELL = 57
BT_OPS_PER_STEP = 30


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    int32 operations over the issue rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "int_ops": n_ops}


def dp_bound(inputs, out) -> dict:
    """Bound of one DP call: its inputs read and its score and dirs
    written once; the operations of the lanes its band updates (the live
    16-aligned [offs, off_ends] span of every wavefront)."""
    offs, off_ends = out[2], out[3]
    live = off_ends >= 0
    cells = float(((off_ends - offs + 1) * live).sum())
    n_bytes = sum(a.numel() * a.element_size() for a in inputs if a is not None)
    n_bytes += out[0].numel() * 4 + out[1].numel()
    return {**bound(n_bytes, cells * DP_OPS_PER_CELL), "cells": cells}


def backtrack_bound(out, N: int) -> dict:
    """Bound of one backtrack: one dirs byte read and one op written per
    walk step, the op rows, end points and lengths."""
    steps = float((out[0] != 255).sum())
    n_bytes = steps + out[0].numel() + 8 * N + 12 * N
    return {**bound(n_bytes, steps * BT_OPS_PER_STEP), "steps": steps}


def kernel_vs_plain(kern, plain, cuda: bool, plain_runs: int = 2):
    """Both versions' outputs and times: 3 warm-up launches (load the
    library, lift the clocks), then plain, 5 rounds of 10 launches, plain.
    One reading of either side alone swings with the host's enqueue
    latency, so the kernel takes the median of the rounds and the plain
    version the better of its runs (one run only where it takes seconds)."""
    import torch

    def timed(fn, reps):
        if cuda:
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                out = fn()
            e1.record()
            torch.cuda.synchronize()
            return out, e0.elapsed_time(e1) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return out, (time.perf_counter() - t0) * 1e3 / reps

    for _ in range(3):
        kern()
    plain_out, plain_ms = timed(plain, 1)
    runs = [plain_ms]
    rounds = []
    for _ in range(KERNEL_ROUNDS):
        kern_out, ms = timed(kern, KERNEL_REPS)
        rounds.append(ms)
    if plain_runs > 1:
        runs.append(timed(plain, 1)[1])
    return kern_out, plain_out, {
        "kernel_ms": float(np.median(rounds)), "kernel_ms_rounds": rounds,
        "plain_ms": min(runs), "plain_ms_runs": runs}


def _max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def kernel_build_info(built, name: str) -> dict:
    """ptxas registers, static shared memory and spills of a kernel's
    entries, and the DPX instructions in its SASS (must be > 0)."""
    sass = sass_vi_ops(built[name][0])
    check(sass["dpx"] > 0, f"no DPX instruction in {name}'s SASS: {sass}")
    return {"ptxas": ptxas_info(built[name][2]), "sass": sass}


def backtrack_vs_plain(dirs, ln, bd, L: int, cuda: bool, fold: bool = False) -> tuple:
    """The backtrack kernel on a DP call's dirs (tlens = qlens, the
    short-read step's call) against the plain walk, timed as
    kernel_vs_plain times; exact. Returns (kernel outputs, report)."""
    from gdiet_tpu_torch.ops import extd2
    from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

    out, plain, times = kernel_vs_plain(
        lambda: extd2.backtrack_band(dirs, ln, ln, bd, L, L, fold=fold),
        lambda: backtrack_antidiag(dirs, ln, bd, L, fold=fold), cuda)
    err = check_equal(out, plain, BT_OUTPUTS, f"backtrack_band (fold {fold}) on {len(ln)} rows")
    return out, {**times, "max_abs_err": err, **walk_report(out, times["kernel_ms"], len(ln))}


def phase_kernel(device, N: int, L: int, qlen: int, card: str, built=None) -> dict:
    """The extd2 kernel (one warp per row at 160 lanes) against its plain
    version, then the backtrack kernel on its dirs against the plain walk.
    With ``built``: ptxas registers/spills and the DPX count."""
    import torch

    from gdiet_tpu_torch.ops import dp, extd2

    cuda = torch.device(device).type == "cuda"
    Q, T, lens, band = dp_pairs(N, L, qlen)
    q, t, ln, bd = (torch.from_numpy(a).to(device) for a in (Q, T, lens, band))
    kern_out, plain_out, times = kernel_vs_plain(
        lambda: extd2.extd2_batch(q, t, ln, bd, PARAMS, L),
        lambda: dp.extd2_batch(q, t, ln, bd, PARAMS, L), cuda)
    err = check_equal(kern_out, plain_out, DP_OUTPUTS, f"extd2 on {N} rows")
    _, bt = backtrack_vs_plain(kern_out[1], ln, bd, L, cuda)
    cells = float((lens.astype(np.int64) * lens).sum())
    steps = live_steps(lens, lens)
    res = {"rows": N, "Lmax": L, "qlen": qlen, **times,
           "kernel_mcups": cells / (times["kernel_ms"] * 1e3),
           "plain_mcups": cells / (times["plain_ms"] * 1e3),
           "max_abs_err": err, **dp_bound((q, t, ln, bd), kern_out),
           "longest_live_steps": steps,
           "us_per_wavefront_step": times["kernel_ms"] * 1e3 / max(steps, 1),
           "backtrack": bt, "card": card}
    res["share_of_bound"] = res["bound_ms"] / times["kernel_ms"]
    if built:
        res.update(kernel_build_info(built, "extd2"))
    say("kernel", **res)
    return res


DP_OUTPUTS = ("scores", "dirs", "offs", "off_ends")
BT_OUTPUTS = ("ops", "fin_i", "fin_j")


def check_equal(got, ref, names, what: str) -> int:
    """Every output of a kernel bit-equal to its plain version's. Returns
    the largest difference (0)."""
    import torch

    errs = [_max_err(a, b) if a.shape == b.shape else -1 for a, b in zip(got, ref)]
    for name, a, b, err in zip(names, got, ref, errs):
        check(a.shape == b.shape and torch.equal(a, b), f"{what}: {name} differ (max {err})")
    return max(errs)


def pe_dp_rows(P: int) -> int:
    """DP rows the PE step gives the DP per batch of P pairs: 2P read rows
    times K candidates, cut to the dp_frac share (device_step.dp_rows)."""
    from gdiet_tpu_torch.pipeline.device_step import dp_rows

    return dp_rows(2 * P * sr_options()[1].AF_max_loc, 0.3125)


def phase_kernel_fold(device, N: int, L: int, qlen: int, card: str,
                      phase: str = "kernel_fold", built=None) -> dict:
    """The folded kernel (four warps per kernel row at 256 lanes) against
    its plain version, then the backtrack kernel on its folded dirs against the
    plain folded walk, both equal to the plain walk of the unfolded dirs.
    With ``built``: ptxas registers/spills and the DPX count."""
    import torch

    from gdiet_tpu_torch.ops import dp_fold, extd2
    from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

    cuda = torch.device(device).type == "cuda"
    Q, T, lens, band = dp_pairs(N, L, qlen)
    q, t, ln, bd = (torch.from_numpy(a).to(device) for a in (Q, T, lens, band))
    kern_out, plain_out, times = kernel_vs_plain(
        lambda: extd2.extd2_batch(q, t, ln, bd, PARAMS, L, fold=True),
        lambda: dp_fold.extd2_fold(q, t, ln, bd, PARAMS, L), cuda)
    err = check_equal(kern_out, plain_out, DP_OUTPUTS, f"extd2_fold on {N} rows")
    unfold = extd2.extd2_batch(q, t, ln, bd, PARAMS, L)
    check(torch.equal(unfold[0], kern_out[0]), "folded and unfolded scores differ")
    bt_f, bt = backtrack_vs_plain(kern_out[1], ln, bd, L, cuda, fold=True)
    bt_u = backtrack_antidiag(unfold[1], ln, bd, L)
    for name, a, b in zip(BT_OUTPUTS, bt_f, bt_u):
        check(torch.equal(a, b), f"folded and unfolded backtracks differ in {name}")
    H, Tf, _ = dp_fold.fold_geometry(L)
    _, Nrows, C = dp_fold.fold_split(N, Tf)
    cells = float((lens.astype(np.int64) * lens).sum())
    res = {"rows": N, "Lmax": L, "qlen": qlen, "kernel_rows": Nrows, "passes": C,
           "H": H, "lanes": Tf, **times,
           "kernel_mcups": cells / (times["kernel_ms"] * 1e3),
           "plain_mcups": cells / (times["plain_ms"] * 1e3),
           "max_abs_err": err, "backtrack_equal_to_unfolded": True,
           **dp_bound((q, t, ln, bd), kern_out),
           "serial_wavefronts": (C + 1) * H,
           "us_per_wavefront_step": times["kernel_ms"] * 1e3 / ((C + 1) * H),
           "backtrack": bt, "card": card}
    res["share_of_bound"] = res["bound_ms"] / times["kernel_ms"]
    if built:
        res.update(kernel_build_info(built, "extd2_fold"))
    say(phase, **res)
    return res


def phase_prev(prev: pathlib.Path, card: str) -> dict:
    """``--prev DIR``: the earlier sources of extd2.cu and extd2_fold.cu in
    DIR (same C entry points), built beside the checkout's, each one nvcc,
    started together. Each kernel is timed in turns against its earlier
    source on the kernel phases' inputs (earlier, current, current,
    earlier; each a median of KERNEL_ROUNDS rounds of KERNEL_REPS launches,
    CUDA events); the two sources' outputs must be equal (exact)."""
    import ctypes
    import hashlib

    import torch

    from gdiet_tpu_torch.ops import extd2

    build = extd2.BUILD_DIR / ("prev_" + hashlib.sha256(str(prev.resolve()).encode())
                               .hexdigest()[:12])
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("extd2", "extd2_fold"):
        so = build / f"{name}.so"
        cmd = [extd2._nvcc(), *extd2.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
               str(prev / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs, logs = {}, {}
    for name, (proc, so) in procs.items():
        logs[name], _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"nvcc failed on the earlier {name}.cu:\n{logs[name]}")
        lib = ctypes.CDLL(str(so))
        entry, argtypes = extd2.ENTRIES[name]
        getattr(lib, entry).restype = ctypes.c_int
        getattr(lib, entry).argtypes = argtypes
        libs[name] = lib

    def rounds_ms(fn):
        torch.cuda.synchronize()
        ms = []
        for _ in range(KERNEL_ROUNDS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(KERNEL_REPS):
                fn()
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1) / KERNEL_REPS)
        return float(np.median(ms))

    out = {}
    for tag, name, N, fold in (("extd2", "extd2", KERNEL_SHAPE["N"], False),
                               ("extd2_fold", "extd2_fold", KERNEL_SHAPE["N"], True),
                               ("extd2_fold_pe", "extd2_fold", pe_dp_rows(PE_PAIRS), True)):
        Q, T, lens, band = dp_pairs(N, KERNEL_SHAPE["L"], KERNEL_SHAPE["qlen"])
        q, t, ln, bd = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
        L = KERNEL_SHAPE["L"]

        def fn():
            return extd2.extd2_batch(q, t, ln, bd, PARAMS, L, fold=fold)

        cur = extd2._library(name)
        for _ in range(3):
            new_out = fn()
        extd2._libs[name] = libs[name]
        try:
            for _ in range(3):
                old_out = fn()
            err = check_equal(old_out, new_out, DP_OUTPUTS, f"{tag}: earlier and current sources")
            times = []
            for lib in (libs[name], cur, cur, libs[name]):
                extd2._libs[name] = lib
                times.append(rounds_ms(fn))
        finally:
            extd2._libs[name] = cur
        old_ms, new_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        out[tag] = {"rows": N, "earlier_ms": old_ms, "current_ms": new_ms,
                    "speedup": old_ms / new_ms, "turns_ms": times, "max_abs_err": err}
    out["earlier_ptxas"] = {name: ptxas_info(log) for name, log in logs.items()}
    out["earlier_sass"] = {name: sass_vi_ops(build / f"{name}.so") for name in libs}
    say("prev", **out, source=str(prev), card=card)
    return out


def _map_sam(mapper, reads) -> list:
    sam = b"".join(bytes(b) for b in mapper.map_stream_sam(iter([reads])))
    return sam.decode().splitlines()


def backtrack_counts_reset() -> None:
    from gdiet_tpu_torch.ops import extd2
    from gdiet_tpu_torch.pipeline import device_step

    extd2.backtrack_launches.reset()
    device_step.backtrack_calls.reset()


def backtrack_counts(what: str, cuda: bool) -> tuple:
    """(backtrack kernel launches, plain backtrack calls) since the last
    reset; on the card the kernel must have run and the plain walk not."""
    from gdiet_tpu_torch.ops import extd2
    from gdiet_tpu_torch.pipeline import device_step

    n, plain = extd2.backtrack_launches.n, device_step.backtrack_calls.n
    if cuda:
        check(n > 0, f"{what} launched no backtrack kernel")
        check(plain == 0, f"{what} called the plain backtrack {plain} times")
    return n, plain


def phase_golden(device) -> dict:
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.io.fastx import read_fastx
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    out = {}
    backtrack_counts_reset()
    for ref, reads, golden, pattern, lmax in (
            ("ref.fa", "reads.fq", "golden.sam", "10", 256),
            ("ref2.fa", "reads2.fq", "golden2_10.sam", "10", 512),
            ("ref2.fa", "reads2.fq", "golden2_1110.sam", "1110", 512),
            ("ref2.fa", "reads2.fq", "golden2_11.sam", "11", 512),
            ("ref2.fa", "reads2.fq", "golden2_110.sam", "110", 512)):
        io_, mo = sr_options(pattern)
        mi = build_index([(r.name, r.seq) for r in read_fastx(str(DATA / ref))], io_, device)
        mapper = ShortReadMapper(mi, mo, max_read_len=lmax, device=device)
        mine = _map_sam(mapper, list(read_fastx(str(DATA / reads))))
        gold = [l for l in (DATA / golden).read_text().splitlines() if not l.startswith("@")]
        same = sum(a == b for a, b in zip(mine, gold))
        check(mine == gold, f"{golden}: {same}/{len(gold)} records equal "
              f"({len(mine)} produced)")
        out[golden] = len(gold)
    bt_n, bt_plain = backtrack_counts("the golden SR runs", device == "cuda")
    say("golden", records=out, identical=True, backtrack_launches=bt_n,
        plain_backtrack_calls=bt_plain)
    return out


def bench_workload(n_reads: int, genome_len: int = GENOME_LEN):
    """bench.py's recipe (bench.py:63-90), in memory: genome, read origins,
    reverse-strand flags, reads (0.5% substitutions, half
    reverse-complemented)."""
    from gdiet_tpu_torch.io.fastx import SeqRecord

    rng = np.random.default_rng(SEED)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, genome_len, dtype=np.int64)
    st = rng.integers(0, genome_len - READ_LEN, n_reads)
    R = genome[st[:, None] + np.arange(READ_LEN)]
    sub = rng.random((n_reads, READ_LEN)) < SUB_RATE
    R = np.where(sub, (R + rng.integers(1, 4, R.shape)) % 4, R)
    rev = rng.random(n_reads) < 0.5
    R[rev] = 3 - R[rev, ::-1]
    seqs = bases[R]
    qual = "I" * READ_LEN
    reads = [SeqRecord(f"r{n}", seqs[n].tobytes().decode(), qual) for n in range(n_reads)]
    return bases[genome].tobytes().decode(), st, rev, reads


def phase_main(device, B: int, n_timed: int, genome_len: int, card: str) -> dict:
    import torch

    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.ops import dp, extd2
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n_reads = B * (n_timed + 1)
    genome, origin, rev, reads = bench_workload(n_reads, genome_len)
    io_, mo = sr_options()
    t0 = time.perf_counter()
    mi = build_index([("chr1", genome)], io_, device)
    sync()
    index_s = time.perf_counter() - t0
    mapper = ShortReadMapper(mi, mo, max_read_len=160, seed_budget=32,
                             shift_seed_budget=16, hit_budget=64,
                             dp_frac=0.3125, device=device)
    batches = [reads[i * B:(i + 1) * B] for i in range(n_timed + 1)]

    # ---- the main path: counts reset just before, read just after ----
    extd2.launches.reset()
    dp.calls.reset()
    backtrack_counts_reset()
    sam = _map_sam(mapper, batches[0])  # warm-up batch
    warm = dict(mapper.stats)
    t0 = time.perf_counter()
    for blob in mapper.map_stream_sam(iter(batches[1:])):
        sam += bytes(blob).decode().splitlines()
    sync()
    wall = time.perf_counter() - t0
    launches, plain_calls = extd2.launches.n, dp.calls.n
    bt_n, bt_plain = backtrack_counts("the main path", cuda)
    stats = mapper.stats
    if cuda:
        check(launches > 0, "the main path launched no extd2 kernel")
        check(plain_calls == 0, f"the main path called the plain DP {plain_calls} times")

    # ---- correctness: origins and the scalar oracle. The reference places
    # a reverse-strand window k-1 bases downstream of the read's origin
    # (gdiet_tpu/oracle/pipeline.py:152-153, after map.c), so a mapped
    # reverse read's POS is origin + 1 + k-1; forward reads sit at
    # origin + 1 ----
    prim = [l.split("\t") for l in sam if not l.startswith("@")]
    prim = [f for f in prim if not int(f[1]) & 0x900]
    check(len(prim) == n_reads, f"{len(prim)} primary records for {n_reads} reads")

    def at_origin(f):
        n = int(f[0][1:])
        expect = int(origin[n]) + 1 + (io_.k - 1 if rev[n] else 0)
        return (f[2] == "chr1" and bool(int(f[1]) & 16) == bool(rev[n])
                and abs(int(f[3]) - expect) <= 10)

    mapped = [f for f in prim if f[2] != "*"]
    near = sum(map(at_origin, mapped))
    check(near >= 0.99 * len(mapped), f"only {near}/{len(mapped)} mapped reads at their origin")
    check(len(mapped) >= 0.9 * n_reads, f"only {len(mapped)}/{n_reads} reads mapped")
    # reads left unmapped must be unmapped by the scalar oracle too
    unmapped = [int(f[0][1:]) for f in prim if f[2] == "*"]
    for n in unmapped[:N_UNMAPPED_ORACLE]:
        check(b"\t4\t*\t" in mapper._oracle_sam(reads[n], 0),
              f"read r{n} is unmapped on the device but mapped by the oracle")
    n_or = min(N_ORACLE, B)
    by_name = {}
    for line in sam:
        by_name.setdefault(line.split("\t", 1)[0], []).append(line)
    oracle = b"".join(mapper._oracle_sam(r, 0) for r in reads[:n_or]).decode().splitlines()
    mine = [l for r in reads[:n_or] for l in by_name[r.name]]
    check(mine == oracle, "SAM of the first reads differs from the scalar oracle's")

    # ---- per-phase device times of one batch ----
    batch, n = batches[1], len(batches[1])
    codes, lens = mapper.native.encode_batch([r.seq for r in batch], 160)
    blobs = mapper.native.make_sr_blobs([r.name for r in batch], [r.seq for r in batch],
                                        [r.qual or "" for r in batch])
    phases = per_phase(mapper, codes, lens, cuda, lambda dev, fetched: mapper._finish_sam(
        (batch, codes, lens, np.zeros(n, bool), np.arange(n), dev, blobs, n), 0, fetched))
    step = step_dp_check(mapper, codes, lens, fold=False)
    res = {"reads": n_reads, "timed_reads": B * n_timed, "batch": B,
           "reads_per_s": B * n_timed / wall, "timed_wall_s": wall,
           "index_build_s": index_s,
           "fallback_reads": warm["fallback_reads"] + stats["fallback_reads"],
           "retried_reads": warm.get("retried_reads", 0) + stats.get("retried_reads", 0),
           "extd2_launches": launches, "plain_dp_calls": plain_calls,
           "backtrack_launches": bt_n, "plain_backtrack_calls": bt_plain, **step,
           "mapped_reads": len(mapped), "mapped_at_origin": near / len(mapped),
           "unmapped_reads": len(unmapped),
           "unmapped_checked_by_oracle": min(len(unmapped), N_UNMAPPED_ORACLE),
           "oracle_reads_equal": n_or,
           "phase_ms": phases, "card": card}
    say("main", **res)
    return res


def step_dp_check(mapper, codes, lens, fold: bool) -> dict:
    """One batch's DP inputs, as the step hands them to ``extd2_batch``,
    through the DP kernel and its plain version, then the DP outputs
    through the backtrack kernel and the plain walk: all exact."""
    from gdiet_tpu_torch.ops import dp, dp_fold, extd2
    from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

    seen = []
    launch = extd2.extd2_batch

    def spy(*args, **kw):
        seen.append((args, kw))
        return launch(*args, **kw)

    extd2.extd2_batch = spy
    try:
        mapper.fused(codes, lens)
    finally:
        extd2.extd2_batch = launch
    check(len(seen) == 1 and bool(seen[0][1].get("fold")) == fold,
          f"the step made no {'folded' if fold else 'unfolded'} DP call")
    (q, t, ln, bd, params, L), _ = seen[0]
    check(tuple(params) == PARAMS, f"the step's scoring {params} is not {PARAMS}")
    plain = dp_fold.extd2_fold if fold else dp.extd2_batch
    got = extd2.extd2_batch(q, t, ln, bd, PARAMS, L, fold=fold)
    what = "extd2_fold" if fold else "extd2"
    dp_err = check_equal(got, plain(q, t, ln, bd, PARAMS, L), DP_OUTPUTS,
                         f"{what} on the step's DP inputs")
    bt_err = check_equal(extd2.backtrack_band(got[1], ln, ln, bd, L, L, fold=fold),
                         backtrack_antidiag(got[1], ln, bd, L, fold=fold), BT_OUTPUTS,
                         "backtrack_band on the step's DP outputs")
    return {"step_dp_rows": int(q.shape[0]), "step_dp_live_rows": int((ln > 0).sum()),
            "step_dp_max_abs_err": dp_err, "step_backtrack_max_abs_err": bt_err}


def per_phase(mapper, codes, lens, cuda: bool, finish) -> dict:
    """Device time of each step phase for one batch (CUDA events at the
    phase boundaries), then D2H and ``finish(dev, fetched)``, the native
    host finish (host clock)."""
    import torch

    marks = []

    def mark(name):
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        else:
            marks.append((name, time.perf_counter()))

    mark("start")
    dev = mapper.fused(codes, lens, mark=mark)
    if cuda:
        torch.cuda.synchronize()
    out = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        out[name] = a.elapsed_time(b) if cuda else (b - a) * 1e3
    t0 = time.perf_counter()
    fetched = mapper.fused.fetch(dev, len(lens))
    out["d2h"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    finish(dev, fetched)
    out["host_finish"] = (time.perf_counter() - t0) * 1e3
    return out


def phase_golden_pe(card: str) -> dict:
    """The PE fixture through the port's CLI: cuda with the fold, cpu (the
    plain versions) and cuda without the fold must write the same records;
    R1 records match the reference's single-end golden except for what
    pairing rewrites (FLAG PE bits, MAPQ, mate columns)."""
    import os
    import tempfile

    from gdiet_tpu_torch import cli
    from gdiet_tpu_torch.ops import extd2
    from gdiet_tpu_torch.testing import r1_vs_single_end, sam_body

    inputs = [str(DATA / f) for f in ("ref_pe.fa", "reads_pe_1.fq", "reads_pe_2.fq")]
    runs, bt = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, device, fold in (("cuda_fold", "cuda", "1"), ("cpu_fold", "cpu", "1"),
                                   ("cuda_unfold", "cuda", "0")):
            os.environ["GDIET_DP_FOLD"] = fold
            n0 = extd2.fold_launches.n
            backtrack_counts_reset()
            out = pathlib.Path(tmp) / f"{name}.sam"
            check(cli.main(["--device", device, *PE_ARGS, "-o", str(out), *inputs]) == 0,
                  f"PE CLI on {device} (fold {fold}) failed")
            runs[name] = sam_body(out)
            if device == "cuda":
                bt[name] = backtrack_counts(f"the PE CLI ({name})", True)
            if name == "cuda_fold":
                check(extd2.fold_launches.n > n0, "the PE CLI launched no fold kernel")
    os.environ.pop("GDIET_DP_FOLD")
    ref = runs["cuda_fold"]
    for name in ("cpu_fold", "cuda_unfold"):
        same = sum(a == b for a, b in zip(ref, runs[name]))
        check(runs[name] == ref, f"PE records differ from {name}: {same}/{len(ref)} equal")
    n_checked, bad = r1_vs_single_end(ref, sam_body(DATA / "golden_pe_r1.sam"))
    check(not bad, f"R1 records {bad[:5]} differ from golden_pe_r1.sam")
    check(n_checked > 200, f"only {n_checked} R1 records checked")
    res = {"records": len(ref), "identical_cpu_and_unfolded": True,
           "r1_checked_against_golden": n_checked,
           "backtrack_launches_and_plain_calls": bt, "card": card}
    say("golden_pe", **res)
    return res


def pe_workload(n_pairs: int, genome_len: int = GENOME_LEN):
    """FR pairs from bench_workload's genome: fragments of FRAG_MIN-FRAG_MAX
    bp, 150 bp ends at 0.5% substitutions, half the fragments from the
    reverse strand. Returns (genome, origin [n, 2] leftmost base of each
    end, rev [n, 2] reverse-strand flags, pairs)."""
    from gdiet_tpu_torch.io.fastx import SeqRecord

    genome = np.random.default_rng(SEED).integers(0, 4, genome_len, dtype=np.int64)
    rng = np.random.default_rng(SEED + 1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    frag = rng.integers(FRAG_MIN, FRAG_MAX + 1, n_pairs)
    st = rng.integers(0, genome_len - frag)
    ends = []
    for o in (st, st + frag - READ_LEN):
        E = genome[o[:, None] + np.arange(READ_LEN)]
        sub = rng.random(E.shape) < SUB_RATE
        ends.append(np.where(sub, (E + rng.integers(1, 4, E.shape)) % 4, E))
    left, right_rc = ends[0], 3 - ends[1][:, ::-1]
    flip = rng.random(n_pairs) < 0.5  # R1 from the right end's reverse strand
    R1 = np.where(flip[:, None], right_rc, left)
    R2 = np.where(flip[:, None], left, right_rc)
    origin = np.stack([np.where(flip, st + frag - READ_LEN, st),
                       np.where(flip, st, st + frag - READ_LEN)], 1)
    rev = np.stack([flip, ~flip], 1)
    qual = "I" * READ_LEN
    s1, s2 = bases[R1], bases[R2]
    pairs = [(SeqRecord(f"p{n}/1", s1[n].tobytes().decode(), qual),
              SeqRecord(f"p{n}/2", s2[n].tobytes().decode(), qual)) for n in range(n_pairs)]
    return bases[genome].tobytes().decode(), origin, rev, pairs


def phase_pe(device, P: int, n_timed: int, genome_len: int, card: str) -> dict:
    import torch

    from gdiet_tpu_torch import config
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.ops import dp, dp_fold, extd2
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n_pairs = P * (n_timed + 1)
    genome, origin, rev, pairs = pe_workload(n_pairs, genome_len)
    io_, mo = sr_options()
    mo.flag |= config.MM_F_OUT_SAM | config.MM_F_CIGAR  # -a
    mi = build_index([("chr1", genome)], io_, device)

    def make_mapper(fold: bool) -> ShortReadMapper:
        # the JAX runtime's PE budgets at Lmax 160 (runtime.py:378-385)
        return ShortReadMapper(mi, mo, max_read_len=160, seed_budget=32,
                               shift_seed_budget=16, hit_budget=64,
                               dp_frac=0.3125, device=device, dp_fold=fold)

    mapper, unfolded = make_mapper(True), make_mapper(False)
    check(mapper.fused.cfg.dp_fold and not unfolded.fused.cfg.dp_fold,
          "dp_fold did not select the folded DP")
    batches = [pairs[i * P:(i + 1) * P] for i in range(n_timed + 1)]

    def run(m, bs) -> list:
        return [l for b in m.map_stream_sam_pe(iter(bs)) for l in bytes(b).decode().splitlines()]

    # ---- the PE path: counts reset just before, read just after ----
    counts = (extd2.launches, extd2.fold_launches, dp.calls, dp_fold.calls)
    for c in counts:
        c.reset()
    backtrack_counts_reset()
    sam = run(mapper, batches[:1])  # warm-up batch
    first_batch = list(sam)
    warm = dict(mapper.stats)
    t0 = time.perf_counter()
    sam += run(mapper, batches[1:])
    sync()
    wall = time.perf_counter() - t0
    unfold_launches, fold_launches, plain_calls, plain_fold_calls = (c.n for c in counts)
    bt_n, bt_plain = backtrack_counts("the PE path", cuda)
    if cuda:
        check(fold_launches > 0, "the PE path launched no extd2_fold kernel")
        check(plain_fold_calls == 0 and plain_calls == 0,
              f"the PE path called the plain DP ({plain_calls} unfolded, "
              f"{plain_fold_calls} folded)")
        check(unfold_launches == 0, f"the PE path launched the unfolded kernel {unfold_launches} times")

    # ---- correctness: placement, the oracle, fold off ----
    prim = [f for f in (l.split("\t") for l in sam) if not int(f[1]) & 0x900]
    check(len(prim) == 2 * n_pairs, f"{len(prim)} primary records for {n_pairs} pairs")
    flips = mapper._pe_flips()

    def at_origin(f):
        n, seg = int(f[0][1:]), 0 if int(f[1]) & 0x40 else 1
        is_rev = bool(int(f[1]) & 16)
        # the reference's reverse-strand window sits k-1 bases downstream
        # of the origin, in the orientation the end was MAPPED in
        shift = io_.k - 1 if is_rev != bool(flips[seg]) else 0
        return (f[2] == "chr1" and is_rev == bool(rev[n, seg])
                and abs(int(f[3]) - (int(origin[n, seg]) + 1 + shift)) <= 10)

    # an unmapped end carries its mate's RNAME and POS: select by flag 0x4
    mapped = [f for f in prim if not int(f[1]) & 4]
    near = sum(map(at_origin, mapped))
    check(near >= 0.99 * len(mapped), f"only {near}/{len(mapped)} mapped ends at their origin")
    ends_mapped = {}
    for f in mapped:
        ends_mapped[f[0]] = ends_mapped.get(f[0], 0) + 1
    both = sum(v == 2 for v in ends_mapped.values())
    check(both >= 0.9 * n_pairs, f"only {both}/{n_pairs} pairs with both ends mapped")
    by_name = {}
    for line in first_batch:
        by_name.setdefault(line.split("\t", 1)[0], []).append(line)
    oracle = b"".join(mapper._oracle_sam_pe(p, 0) for p in pairs[:PE_ORACLE]).decode().splitlines()
    mine = [l for n in range(PE_ORACLE) for l in by_name[f"p{n}"]]
    check(mine == oracle, "SAM of the first pairs differs from the oracle's PE finish")
    backtrack_counts_reset()
    check(run(unfolded, batches[:1]) == first_batch,
          "the first batch's SAM differs with the fold off")
    bt_unfold = backtrack_counts("the PE path with the fold off", cuda)

    # ---- per-phase device times of one batch ----
    state = mapper._prepare_pe(batches[1], P)
    sync()
    codes, lens = state[1], state[2]
    phases = per_phase(mapper, codes, lens, cuda, lambda dev, fetched: mapper._finish_pe(
        (*state[:4], dev, *state[5:]), 0, fetched))

    # ---- the fold and backtrack kernels on the DP inputs the step gives them ----
    step = step_dp_check(mapper, codes, lens, fold=True)
    res = {"pairs": n_pairs, "timed_pairs": P * n_timed, "batch_pairs": P,
           "pairs_per_s": P * n_timed / wall, "timed_wall_s": wall,
           "fallback_pairs": warm["fallback_reads"] + mapper.stats["fallback_reads"],
           "extd2_fold_launches": fold_launches, "extd2_launches": unfold_launches,
           "plain_dp_calls": plain_calls, "plain_fold_calls": plain_fold_calls,
           "backtrack_launches": bt_n, "plain_backtrack_calls": bt_plain,
           "fold_off_backtrack_launches_and_plain_calls": bt_unfold,
           "pairs_both_mapped": both / n_pairs, "mapped_at_origin": near / len(mapped),
           **step,
           "oracle_pairs_equal": PE_ORACLE, "first_batch_equal_unfolded": True,
           "phase_ms": phases, "card": card}
    say("pe", **res)
    return res


LR_PARAMS = (1, 4, 6, 2, 26, 1)  # the map-hifi preset's scoring
LR_BANDS = (500, 1300)  # bench.py's HiFi and ONT recipes' bandwidths
LR_READS, LR_BATCH, LR_TIMED, LR_ORACLE = 1024, 256, 3, 32
HIFI_ARGS = ["-a", "-t", "1", "-x", "map-hifi", "-Z", "10", "-W", "2", "-k", "19",
             "-w", "19", "-i", "0.2", "-r", "200", "--vt_dis=650", "--vt_nb_loc=5",
             "--vt_df1=0.0106", "--vt_df2=0.2", "-s", "100", "--vt_cov", "0.04",
             "--vt_f=0.04", "-v", "1"]
ONT_ARGS = ["-a", "-t", "1", "-x", "map-ont", "-Z", "10", "-W", "2", "-k", "15",
            "-w", "10", "-r", "300", "--vt_dis=1000", "--vt_nb_loc=3",
            "--vt_df1=0.007", "--vt_df2=0.007", "-s", "100", "--vt_cov", "0.1",
            "-v", "1"]


def band_windows(N: int, Lmax: int, Lt: int, seed: int = 3):
    """Seeded long-read DP windows: equal, mutated (1% substitutions),
    with 1-8 base indels, unrelated; N codes, dead rows; qlen 3/4..1 of
    Lmax, tlen qlen..qlen+64 (as the mapper's segment windows)."""
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 4, (N, Lmax), dtype=np.uint8)
    T = rng.integers(0, 4, (N, Lt), dtype=np.uint8)
    lens = rng.integers(Lmax * 3 // 4, Lmax + 1, N).astype(np.int32)
    tlens = np.minimum(lens + rng.integers(0, 65, N), Lt).astype(np.int32)
    for n in range(N):
        kind = n % 4
        if kind == 3:
            continue  # unrelated
        t = Q[n].copy()
        if kind >= 1:
            sub = rng.random(Lmax) < 0.01
            t[sub] = (t[sub] + 1) % 4
        if kind == 2:
            for _ in range(3):
                p, g = int(rng.integers(10, Lmax - 10)), int(rng.integers(1, 9))
                t = (np.concatenate([t[:p], rng.integers(0, 4, g), t[p:]]) if rng.random() < 0.5
                     else np.concatenate([t[:p], t[p + g:], rng.integers(0, 4, g)]))[:Lmax]
        T[n, :Lmax] = t
    Q[rng.random(Q.shape) < 0.001] = 4
    T[rng.random(T.shape) < 0.001] = 4
    lens[7::29] = 0
    return Q, T, lens, tlens


# a shared-memory load's latency on the card, for the backtrack's serial
# floor (its walk is a chain of dependent loads)
SMEM_LOAD_CYCLES, SM_CLOCK_HZ = 30, 1.98e9


def live_steps(lens, tlens) -> int:
    """The longest candidate's live wavefronts, qlen + tlen - 1 (0 for a
    qlen-0 candidate): where extd2_band.cu ends the launch."""
    return int(max(((lens + tlens - 1) * (lens > 0)).max(), 0))


def walk_report(bt_out, bt_ms: float, N: int) -> dict:
    """The backtrack's bound, its longest walk, us per walk step of that
    walk, and the serial floor beside the bound: the longest walk's steps
    times one shared-memory load."""
    longest = int((bt_out[0] != 255).sum(1).max()) if N else 0
    return {**backtrack_bound(bt_out, N), "longest_walk_steps": longest,
            "us_per_walk_step": bt_ms * 1e3 / max(longest, 1),
            "serial_floor_ms": longest * SMEM_LOAD_CYCLES / SM_CLOCK_HZ * 1e3}


def phase_kernel_band(device, card: str, N: int = 64, Lmax: int = 2048,
                      Lt: int = 3072, big: tuple = (4096, 5120), built=None) -> dict:
    """The banded lane window kernel against its plain version at the
    (2048, 3072) long-read bucket, at band budgets 500 (WB 768) and 1300
    (WB 1,536), two lanes per thread: scores, every
    dirs byte, offs and off_ends exact; the backtrack kernel on those dirs
    equal to the plain backtrack. The unwindowed (512, 1024) bucket of
    map-hifi's default band 1000 through extd2.cu (1,024 threads) and the
    backtrack kernel's full-width mode, exact. Then both kernels alone at
    the HiFi workload's largest bucket, (4096, 5120) with band 500. Per
    run: us per wavefront step of the longest candidate's live steps, us
    per walk step of the longest walk and the walk's serial floor. With
    ``built`` (phase_build's libraries and logs): ptxas registers, static
    shared memory and spills of both kernels, and the DPX instructions in
    the band kernel's SASS (must be > 0)."""
    import torch

    from gdiet_tpu_torch.ops import dp, dp_band, extd2
    from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

    cuda = torch.device(device).type == "cuda"
    U = dp_band.LR_UNROLL
    out = {"runs": []}
    for bb in LR_BANDS:
        Q, T, lens, tlens = band_windows(N, Lmax, Lt)
        band = np.full(N, bb, np.int32)
        q, t, ln, bd, tl = (torch.from_numpy(a).to(device) for a in (Q, T, lens, band, tlens))

        def kern():
            return extd2.extd2_batch(q, t, ln, bd, LR_PARAMS, Lmax, tlens=tl, Lt=Lt,
                                     band_budget=bb, unroll=U)

        kern_out, plain_out, times = kernel_vs_plain(
            kern, lambda: dp_band.extd2_band(q, t, ln, bd, LR_PARAMS, Lmax, tl, Lt, bb, U),
            cuda, plain_runs=1)
        err = check_equal(kern_out, plain_out, DP_OUTPUTS,
                          f"extd2_band at band {bb}")
        bt_out, bt_plain, bt_times = kernel_vs_plain(
            lambda: extd2.backtrack_band(kern_out[1], ln, tl, bd, Lmax, Lt,
                                         band_budget=bb, unroll=U),
            lambda: backtrack_antidiag(kern_out[1], ln, bd, Lmax, tlens=tl, Lt=Lt,
                                       band_budget=bb, unroll=U),
            cuda, plain_runs=1)
        bt_err = check_equal(bt_out, bt_plain, BT_OUTPUTS,
                             f"backtrack_band at band {bb}")
        _, R, WB = dp_band.band_shape(Lmax, Lt, bb, U)
        steps = live_steps(lens, tlens)
        run = {"band_budget": bb, "WB": WB, "R": R, **times, "max_abs_err": err,
               **dp_bound((q, t, ln, bd, tl), kern_out),
               "live_rows": int((lens > 0).sum()),
               "reach_corner": int((kern_out[0] > -0x40000000).sum()),
               "longest_live_steps": steps,
               "us_per_wavefront_step": times["kernel_ms"] * 1e3 / max(steps, 1),
               "backtrack": {**bt_times, "max_abs_err": bt_err,
                             **walk_report(bt_out, bt_times["kernel_ms"], N)}}
        out["runs"].append(run)
    # map-hifi's default bw 1000 leaves the (512, 1024) bucket unwindowed:
    # extd2.cu at 1,024 threads per block, the backtrack kernel on the
    # full-width layout
    Lq1, Lt1, bw1 = 512, 1024, 1000
    check(dp_band.window_geometry(bw1, Lt1, U) is None, "the (512, 1024) bucket is windowed")
    Q, T, lens, tlens = band_windows(N, Lq1, Lt1, seed=5)
    band = np.full(N, bw1, np.int32)
    q, t, ln, bd, tl = (torch.from_numpy(a).to(device) for a in (Q, T, lens, band, tlens))
    n0 = extd2.launches.n
    fw = extd2.extd2_batch(q, t, ln, bd, LR_PARAMS, Lq1, tlens=tl, Lt=Lt1,
                           band_budget=bw1, unroll=U)
    check(not cuda or extd2.launches.n == n0 + 1, "the (512, 1024) bucket launched no extd2")
    fw_err = check_equal(fw, dp.extd2_batch(q, t, ln, bd, LR_PARAMS, Lq1, tl, Lt1),
                         DP_OUTPUTS, "extd2 at (512, 1024)")
    fw_bt_err = check_equal(
        extd2.backtrack_band(fw[1], ln, tl, bd, Lq1, Lt1, band_budget=bw1, unroll=U),
        backtrack_antidiag(fw[1], ln, bd, Lq1, tlens=tl, Lt=Lt1, band_budget=bw1, unroll=U),
        BT_OUTPUTS, "backtrack_band on the full-width layout")
    out["full_width_bucket"] = {"Lmax": Lq1, "Lt": Lt1, "band_budget": bw1,
                                "threads": dp.round16(Lt1), "max_abs_err": fw_err,
                                "backtrack_max_abs_err": fw_bt_err}
    # the HiFi workload's largest bucket: the kernels alone
    (Lq4, Lt4), bb = big, LR_BANDS[0]
    Q, T, lens, tlens = band_windows(N, Lq4, Lt4, seed=4)
    band = np.full(N, bb, np.int32)
    q, t, ln, bd, tl = (torch.from_numpy(a).to(device) for a in (Q, T, lens, band, tlens))

    def kern_big():
        return extd2.extd2_batch(q, t, ln, bd, LR_PARAMS, Lq4, tlens=tl, Lt=Lt4,
                                 band_budget=bb, unroll=U)

    big, _, big_times = kernel_vs_plain(kern_big, lambda: None, cuda, plain_runs=1)
    bt, _, bt_times = kernel_vs_plain(
        lambda: extd2.backtrack_band(big[1], ln, tl, bd, Lq4, Lt4, band_budget=bb, unroll=U),
        lambda: None, cuda, plain_runs=1)
    _, R, WB = dp_band.band_shape(Lq4, Lt4, bb, U)
    steps = live_steps(lens, tlens)
    out["hifi_largest_bucket"] = {
        "Lmax": Lq4, "Lt": Lt4, "band_budget": bb, "WB": WB, "R": R, "N": N,
        "kernel_ms": big_times["kernel_ms"], "kernel_ms_rounds": big_times["kernel_ms_rounds"],
        **dp_bound((q, t, ln, bd, tl), big), "longest_live_steps": steps,
        "us_per_wavefront_step": big_times["kernel_ms"] * 1e3 / max(steps, 1),
        "backtrack_ms": bt_times["kernel_ms"],
        "backtrack": walk_report(bt, bt_times["kernel_ms"], N)}
    if built:
        info = {k: ptxas_info(built[k][2]) for k in ("extd2_band", "backtrack_band")}
        sass = {k: sass_vi_ops(built[k][0]) for k in ("extd2_band", "backtrack_band")}
        check(sass["extd2_band"]["dpx"] > 0, f"no DPX instruction in extd2_band's SASS: {sass}")
        out.update(ptxas=info, sass=sass)
    out.update(N=N, Lmax=Lmax, Lt=Lt, card=card)
    say("kernel_band", **out)
    return out


def phase_golden_lr(card: str, device: str = "cuda") -> dict:
    """The long-read fixture (64 reads) through the port's CLI on the card
    with make_lr_fixtures.py's HiFi and ONT arguments: records byte-equal
    to the reference binary's golden SAMs, through the band kernel."""
    import tempfile

    from gdiet_tpu_torch import cli
    from gdiet_tpu_torch.ops import extd2
    from gdiet_tpu_torch.testing import sam_body

    inputs = [str(DATA / "ref_lr.fa"), str(DATA / "reads_lr.fq")]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, args in (("hifi", HIFI_ARGS), ("ont", ONT_ARGS)):
            n0, b0 = extd2.band_launches.n, extd2.backtrack_launches.n
            path = pathlib.Path(tmp) / f"{tag}.sam"
            t0 = time.perf_counter()
            check(cli.main(["--device", device, *args, "-o", str(path), *inputs]) == 0,
                  f"LR CLI ({tag}) failed")
            mine, gold = sam_body(path), sam_body(DATA / f"golden_lr_{tag}.sam")
            same = sum(a == b for a, b in zip(mine, gold))
            check(mine == gold, f"golden_lr_{tag}.sam: {same}/{len(gold)} records equal "
                  f"({len(mine)} produced)")
            check(device != "cuda" or (extd2.band_launches.n > n0
                                       and extd2.backtrack_launches.n > b0),
                  f"the LR CLI ({tag}) launched no band or backtrack kernel")
            out[tag] = {"records": len(gold), "seconds": time.perf_counter() - t0,
                        "band_launches": extd2.band_launches.n - n0,
                        "backtrack_launches": extd2.backtrack_launches.n - b0}
    say("golden_lr", **out, identical=True, card=card)
    return out


def lr_workload(n_reads: int, genome_len: int = GENOME_LEN):
    """bench.py's gen_lr_reads recipe (bench.py:268-295) on the bench
    genome, in memory: 1,500-4,000 bp reads at 1% substitutions, half
    reverse-complemented."""
    from gdiet_tpu_torch.io.fastx import SeqRecord

    genome = np.random.default_rng(SEED).integers(0, 4, genome_len, dtype=np.int64)
    rng = np.random.default_rng(SEED + 1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for n in range(n_reads):
        L = int(rng.integers(1500, 4000))
        st = int(rng.integers(0, genome_len - L))
        r = genome[st: st + L].copy()
        for _ in range(rng.binomial(L, 0.01)):
            p = int(rng.integers(0, L))
            r[p] = (r[p] + int(rng.integers(1, 4))) % 4
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads.append(SeqRecord(f"h{n}", bases[r].tobytes().decode(), "I" * L))
    return bases[genome].tobytes().decode(), reads


def phase_lr(device, n_timed: int, genome_len: int, card: str, B: int = LR_BATCH) -> dict:
    """The HiFi path at full size: bench.py's lr_stats options and mapper
    budgets, batches of B reads, 1 warm-up + n_timed timed through
    map_stream. Checks: >= 90% of reads mapped, the first reads' SAM equal
    to the scalar oracle's, band and backtrack kernel launches > 0 and no
    plain call in the timed window; one batch's per-phase times; one
    chunk's captured DP inputs through the kernels and the plain versions
    once more, exact."""
    import torch

    from gdiet_tpu_torch import config
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.ops import dp_band, extd2
    from gdiet_tpu_torch.oracle import longread as olr
    from gdiet_tpu_torch.pipeline import device_step
    from gdiet_tpu_torch.pipeline.longread import LongReadMapper

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    genome, reads = lr_workload(B * (n_timed + 1), genome_len)
    io_, mo = config.options_for(
        "map-hifi", variant="lr", pattern="10", k=19, w=19, max_seeds=0.2, bw=500,
        vt_dis=650, vt_nb_loc=5, vt_df1=0.0106, vt_df2=0.2, min_dp_max=200,
        vt_cov=0.04, vt_f=0.04)
    mo.flag |= config.MM_F_OUT_SAM | config.MM_F_CIGAR  # -a
    mi = build_index([("chr1", genome)], io_, device)
    mapper = LongReadMapper(mi, mo, max_read_len=4096, seed_budget=512,
                            shift_seed_budget=128, hit_budget=2048, vote_budget=512,
                            device=device)
    batches = [reads[i * B:(i + 1) * B] for i in range(n_timed + 1)]

    # ---- the LR path: counts reset just before, read just after ----
    counts = (extd2.band_launches, extd2.backtrack_launches, extd2.launches,
              dp_band.calls, device_step.backtrack_calls)
    results = list(mapper.map_stream(iter(batches[:1])))  # warm-up batch
    for c in counts:
        c.reset()
    t0 = time.perf_counter()
    results += list(mapper.map_stream(iter(batches[1:])))
    sync()
    wall = time.perf_counter() - t0
    band_n, bt_n, full_n, plain_n, plain_bt_n = (c.n for c in counts)
    if cuda:
        check(band_n > 0 and bt_n > 0,
              f"the LR path launched {band_n} band and {bt_n} backtrack kernels")
        check(plain_n == 0 and plain_bt_n == 0,
              f"the LR path called the plain banded DP {plain_n} and the plain "
              f"backtrack {plain_bt_n} times")
    regs = [r for batch in results for r in batch]
    n_mapped = sum(bool(r) for r in regs)
    check(n_mapped >= 0.9 * len(reads), f"only {n_mapped}/{len(reads)} reads mapped")
    mine = [l for rec, rg in zip(reads[:LR_ORACLE], regs) for l in mapper.regs_to_sam_lines(rec, rg)]
    oracle = [l for rec in reads[:LR_ORACLE] for l in mapper.regs_to_sam_lines(
        rec, olr.map_read_lr(mapper.mi.oracle_view(), rec.seq, mo, mapper.mid_occ, rec.name))]
    check(mine == oracle, "SAM of the first reads differs from the scalar oracle's")

    # ---- per-phase times of one batch (a device sync at each boundary) ----
    acc: dict = {}
    last = [0.0]

    def mark(name):
        sync()
        now = time.perf_counter()
        acc[name] = acc.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    seen = []
    launch = extd2.extd2_batch

    def spy(*args, **kw):
        seen.append((args, kw))
        return launch(*args, **kw)

    mapper.mark = mark
    extd2.extd2_batch = spy
    try:
        sync()
        last[0] = time.perf_counter()
        mapper.map_batch(batches[1])
    finally:
        mapper.mark = None
        extd2.extd2_batch = launch

    # ---- the kernels on the DP inputs the mapper gives them: the
    # smallest windowed bucket of that batch ----
    windowed = [(a, kw) for a, kw in seen if dp_band.band_shape(
        a[5], kw["Lt"], kw["band_budget"], kw["unroll"])[2] is not None]
    check(bool(windowed), "the LR batch made no windowed DP call")
    (q, t, ln, bd, params, L), kw = min(windowed, key=lambda c: c[0][5])
    Lt, bb, U, tl = kw["Lt"], kw["band_budget"], kw["unroll"], kw["tlens"]
    got = extd2.extd2_batch(q, t, ln, bd, params, L, tlens=tl, Lt=Lt, band_budget=bb, unroll=U)
    ref = dp_band.extd2_band(q, t, ln, bd, params, L, tl, Lt, bb, U)
    path_err = check_equal(got, ref, DP_OUTPUTS,
                           "the LR path's DP inputs")
    path_bt_err = check_equal(
        extd2.backtrack_band(got[1], ln, tl, bd, L, Lt, band_budget=bb, unroll=U),
        device_step.backtrack_antidiag(got[1], ln, bd, L, tlens=tl, Lt=Lt,
                                       band_budget=bb, unroll=U),
        BT_OUTPUTS, "the LR path's backtrack")
    res = {"reads": len(reads), "timed_reads": B * n_timed, "batch": B,
           "reads_per_s": B * n_timed / wall, "timed_wall_s": wall,
           "fallback_reads": mapper.stats["fallback_reads"],
           "host_dp_segments": mapper.stats["host_dp_segments"],
           "mapped_reads": n_mapped, "oracle_reads_equal": LR_ORACLE,
           "band_launches": band_n, "backtrack_launches": bt_n,
           "full_width_launches": full_n, "plain_band_calls": plain_n,
           "plain_backtrack_calls": plain_bt_n,
           "phase_ms": acc, "dp_calls_in_batch": len(seen),
           "step_dp": {"Lmax": L, "Lt": Lt, "rows": int(q.shape[0]),
                       "live_rows": int((ln > 0).sum()), "max_abs_err": path_err,
                       "backtrack_max_abs_err": path_bt_err},
           "card": card}
    say("lr", **res)
    return res


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke run of gdiet_tpu_torch.")
    ap.add_argument("--prev", type=pathlib.Path, default=None,
                    help="a directory with earlier extd2.cu and extd2_fold.cu sources: "
                         "time them in turns against the checkout's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this smoke run needs a GPU", file=sys.stderr)
        return 2
    import gdiet_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    print(card, flush=True)
    built = phase_build()
    say("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_s={name: b[1] for name, b in built.items()})
    k = phase_kernel("cuda", card=card, built=built, **KERNEL_SHAPE)
    kf = phase_kernel_fold("cuda", card=card, built=built, **KERNEL_SHAPE)
    kf_pe = phase_kernel_fold("cuda", card=card, phase="kernel_fold_pe",
                              **{**KERNEL_SHAPE, "N": pe_dp_rows(PE_PAIRS)})
    if args.prev is not None:
        phase_prev(args.prev, card)
    phase_golden("cuda")
    m = phase_main("cuda", BENCH_B, N_TIMED, GENOME_LEN, card)
    phase_golden_pe(card)
    pe = phase_pe("cuda", PE_PAIRS, PE_TIMED, GENOME_LEN, card)
    kb = phase_kernel_band("cuda", card, built=built)
    phase_golden_lr(card)
    lr = phase_lr("cuda", LR_TIMED, GENOME_LEN, card)
    src = "gdiet_tpu_torch/csrc/"
    hifi = kb["runs"][0]  # band 500: the HiFi workload's budget
    bound_keys = ("bound_ms", "bound_by")
    print(json.dumps({"kernels": [
        {"name": "extd2", "route": "cuda", "source": src + "extd2.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:170",
         "launches": m["extd2_launches"],
         "max_abs_err": max(k["max_abs_err"], m["step_dp_max_abs_err"],
                            kb["full_width_bucket"]["max_abs_err"]),
         "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
         **{x: k[x] for x in bound_keys}, "library_ms": None},
        {"name": "extd2_band", "route": "cuda", "source": src + "extd2_band.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:170",
         "launches": lr["band_launches"],
         "max_abs_err": max([r["max_abs_err"] for r in kb["runs"]]
                            + [lr["step_dp"]["max_abs_err"]]),
         "ms": hifi["kernel_ms"], "plain_ms": hifi["plain_ms"],
         **{x: hifi[x] for x in bound_keys}, "library_ms": None},
        {"name": "extd2_fold", "route": "cuda", "source": src + "extd2_fold.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:419",
         "launches": pe["extd2_fold_launches"],
         "max_abs_err": max(kf["max_abs_err"], kf_pe["max_abs_err"],
                            pe["step_dp_max_abs_err"]),
         "ms": kf["kernel_ms"], "plain_ms": kf["plain_ms"],
         **{x: kf[x] for x in bound_keys}, "library_ms": None},
        {"name": "backtrack_band", "route": "cuda", "source": src + "backtrack_band.cu",
         "replaces": "gdiet_tpu/pipeline/device_step.py:452",
         "launches": m["backtrack_launches"] + pe["backtrack_launches"]
         + lr["backtrack_launches"],
         "max_abs_err": max([r["backtrack"]["max_abs_err"] for r in kb["runs"]]
                            + [k["backtrack"]["max_abs_err"], kf["backtrack"]["max_abs_err"],
                               kf_pe["backtrack"]["max_abs_err"],
                               m["step_backtrack_max_abs_err"],
                               pe["step_backtrack_max_abs_err"],
                               lr["step_dp"]["backtrack_max_abs_err"]]),
         "ms": k["backtrack"]["kernel_ms"], "plain_ms": k["backtrack"]["plain_ms"],
         **{x: k["backtrack"][x] for x in bound_keys}, "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
