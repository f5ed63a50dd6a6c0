#!/usr/bin/env python3
"""On-card smoke run of gdiet_tpu_torch (the PyTorch/CUDA port).

    python3 chip_smoke.py [--prev DIR]

Needs one CUDA GPU, the CUDA toolkit (nvcc) and a C compiler; imports no
JAX. Phases, each printing one line:

1. device/build: ``nvidia-smi`` name and power limit; the nine CUDA kernel
   sources of the SR, PE and LR paths (the DP's three layouts in int32 and
   int16 lane state, the backtrack, two votes) built from the checkout, one
   ``nvcc`` per source started together (seconds and ``ptxas -v`` output
   per kernel). The DP's lane state on each route: int16 on the LR
   windowed buckets and at the full-width shapes where the int16 kernel
   measured faster (112, 128, 160, 192, 256 and 512 lanes: the SE width
   too since extd2_i16.cu's two rows a warp; the LR (512, 1024) bucket)
   and for the fold at 160 lanes (the SE and PE width, since
   extd2_fold_i16.cu's filler and walker warps), else int32 (unmeasured
   shapes; ``extd2.route_state_dtype``, ``sr_dp_kernel``); the phases
   below check the kernels of each route.
2. kernel: the CUDA ``extd2`` DP kernel (one warp per row) against its
   plain torch version on the card at the short-read main-path shape (6,272
   rows, Lmax = Lt = 160, qlen 150, bands 150-200; seeded pairs with
   substitutions, indels, N bases and empty rows): scores and dirs
   bit-equal (tolerance: exact; on the card the DP leaves offs and off_ends
   to ``dp.band_geometry``). Then the backtrack kernel on its
   dirs against the plain walk, exact. Prints the times (a kernel's as the
   median of 5 rounds of 10 launches, a plain version's as the better of 2
   runs), the bounds, us per wavefront step, the share of the bound, the
   backtrack's serial floor, ptxas registers/spills and the DPX
   instructions in the SASS (``cuobjdump -sass``, > 0).
3. kernel_fold: the folded ``extd2_fold`` kernel (four warps per kernel
   row) against its plain version on the same rows (576 kernel rows, 11
   passes + drain), then again on the rows the PE phase gives it per batch
   (5,120 rows of 4,096 pairs: 384 kernel rows, 14 passes): scores and
   every byte of the raw folded dirs bit-equal; the backtrack
   kernel on the folded dirs equal to the plain folded walk, and both to
   the plain walk of the unfolded kernel's dirs. Times, bounds and build
   facts as in phase 2.
   With ``--prev DIR`` (earlier sources of ``extd2.cu`` and
   ``extd2_fold.cu``): both kernels timed in turns against the earlier
   sources on the same inputs, outputs equal (phase ``prev``; an earlier
   ``extd2_band_i16.cu`` in DIR: phase 21; an earlier ``extd2_i16.cu``:
   phase 22; an earlier ``vote_lr.cu``: phase 23; an earlier
   ``extd2_fold_i16.cu``: phase 24).
4. kernel_vote: the vote kernel ``vote_scan`` (one thread per read, the
   strand halves read in place in column tiles staged through shared
   memory, the K slots in shared memory) against the plain loop on the
   concatenated hit streams the step hands it: one SE batch of the main
   phase (10,016 reads, M = 130, K = 2) and one generic batch (65,536
   reads at the mapper's default budgets, A = 2,048, M = 4,098) at K = 2
   and K = 20; all 11 outputs exact, and the streams valid-first (the
   precondition of ``ops/vote.py``). Times as in phase 2 (the plain loop one
   run), the time of building the concatenated stream, the bound (the
   valid flags up to each strand's end and 12 bytes per valid column, over
   HBM bandwidth; the whole stream's B*M*13 bytes beside it), the serial
   floor (the longest row's walked columns x 24 cycles), ptxas registers
   and spills. With ``--prev DIR`` holding an earlier ``vote_scan.cu`` (one
   thread per row over the concatenated stream): that source timed in
   turns against this one, outputs equal.
5. golden: ``tests/data`` fixtures (``golden.sam`` and ``golden2_*.sam`` for
   patterns 10, 1110, 11 and 110) mapped on the card through
   ``ShortReadMapper.map_stream_sam`` and through ``map_batch`` (regs
   written by ``io/sam.py``), and ``golden_split.sam`` through the CLI
   (``-I 40k --split-prefix``); records must equal the reference binary's
   golden SAM byte for byte. The vote, DP and backtrack kernels launched
   and their plain versions never called (every SR/PE phase below checks
   the same).
6. api: ``Aligner(device="cuda")`` maps each read of ``reads.fq`` (one
   ``map`` call per read, with cs and MD): contig, start, strand, CIGAR
   and MAPQ equal the golden records'.
7. main: the bench workload (2 Mbp genome, 150 bp reads at 0.5%
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
   kernel and the plain walk: exact. One call of the wider retry tier (512
   reads at A = 2,048), timed after a first call that builds it.
8. generic: the bench recipe's 65,536 reads (9.8 Mbp, one mini-batch)
   through the CLI on a prebuilt index: ``-a`` (the fast path), ``-a --MD
   --cs`` and ``-c`` (PAF), the last two through the generic per-record
   writer. Checks: the --MD --cs records without those tags equal the fast
   path's; the first 128 reads' records equal the scalar oracle's, tags
   included; every PAF line agrees with its SAM record. Reads/s of each
   run; one generic batch's per-phase device times, host finish (regs),
   SAM writing and peak device memory per read.
9. golden_pe: the paired-end fixture (``ref_pe.fa``, ``reads_pe_1.fq`` +
   ``reads_pe_2.fq``) through the port's PE CLI on ``cuda`` with
   ``GDIET_DP_FOLD=1``: records equal the same run on ``cpu`` (the plain
   versions) and on ``cuda`` with the fold off, byte for byte, and the R1
   records match ``golden_pe_r1.sam`` as ``tests/test_pe_parity.py`` checks
   them. Both cuda runs launch the backtrack kernel and never the plain
   walk.
10. pe: the PE path at full width with ``GDIET_DP_FOLD=1``: FR pairs of 150
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
11. kernel_band: the int32 banded lane window kernel ``extd2_band`` against its
   plain version at the (2048, 3072) long-read bucket, 64 seeded windows
   (equal, mutated, indels, N codes, dead rows), at band 500 (WB 768) and
   1300 (WB 1,536), two lanes per thread: scores and every dirs byte
   exact, and ``backtrack_band`` on those dirs equal to the plain
   backtrack. The unwindowed (512, 1024) bucket of band 1000 through
   ``extd2`` (1,024 threads) and the backtrack kernel's full-width mode,
   exact. Then both kernels alone at (4096, 5120). Times as in phase 2, the
   plain versions one run each; every kernel's bound from this run's data.
   Also: us per wavefront step over the longest candidate's live steps, us
   per walk step of the longest walk and the walk's serial floor beside its
   bound; ptxas registers, static shared memory and spills of both
   kernels; the DPX instructions in the band kernel's SASS (``cuobjdump
   -sass``, > 0).
12. golden_lr: ``tests/data/ref_lr.fa`` + ``reads_lr.fq`` through the port's
   CLI on ``cuda`` with the HiFi and ONT arguments of
   ``tests/data/make_lr_fixtures.py``: records byte-equal to
   ``golden_lr_hifi.sam`` and ``golden_lr_ont.sam``, through the int16
   band kernel.
13. lr: the HiFi path at full size: bench.py's ``gen_lr_reads`` recipe on
   the bench genome, its ``lr_stats`` options and mapper budgets, 1
   warm-up + 3 timed batches of 256 reads. Counts reset just before and
   read just after. Checks: >= 90% of reads mapped, the first 32 reads'
   SAM equal to the scalar oracle's, int16 DP (band or full width) and
   backtrack kernel launches > 0, no int32 DP launch and no plain banded
   DP or plain backtrack call. One batch's per-phase times; one chunk's
   captured DP inputs (the smallest windowed bucket, int16 lane state)
   through the kernels and the plain versions once more, exact. The LR vote kernel
   launched (twice a batch) and neither the plain LR vote loops nor
   ``lr_step._stream_columns`` called.
14. kernel_vote_lr: ``csrc/vote_lr.cu``'s round 1 (``vote_lr``) and both
   round-2 windows (``vote2_pair``; one warp per read half, 32 columns a
   step) against the plain LR loops on the vote calls captured from one
   HiFi batch (256 reads, M = 1,026, K = 5): every output exact; times and
   bounds as in phase 4, each entry point's device time, the warps
   launched, the stream as the warps walk it (valid columns per half, run
   lengths, scan iterations), the serial floor (the longest half's scan
   iterations x ~270 cycles), the launch floor (an empty kernel's device
   time at the same launch shape); ptxas registers and spills.
15. ont: the ONT path at full size, its first run on the card: bench.py's
   ``gen_ont_reads`` recipe (30 kb reads at 3% substitutions, 1%
   insertions, 1% deletions) and ``ont_stats`` options and budgets, 1
   warm-up + 2 timed batches of 16. Checks: >= 90% of reads mapped; the
   int16 DP, backtrack and vote kernels launched, no int32 DP and no plain
   version called in the timed window; one batch's captured vote stream (M = 8,194) through
   ``vote_lr.cu`` and the plain loops, exact, reported as in phase 14.
   Reads/s, fallbacks and host DP segments (``LongReadMapper.stats``), one
   batch's per-phase times.

16. mesh (after main): the main phase's workload, one batch of 10,016 reads
   at the bench budgets, through ``ShortReadMapper(mesh=...)`` on the
   virtual meshes (2, 2), (1, 4) and (4, 1), every cell on ``cuda:0``
   (``parallel/dist.py``: reads split over the data rows, the index split
   by key range, the shards' hits merged on the card). Launch counts reset
   just before and read just after each meshed run: the vote, DP and
   backtrack kernels launched and no plain version. Exact against the
   single-device mapper on the same batch: meta (``opsrow`` through the op
   rows it points to), ops and the SAM of ``map_stream_sam``. Each data
   row's merged vote stream (M = 2(64 n_ref + 1)) through vote_scan.cu and
   the plain loop, exact, timed as in phase 4. The step's ms per batch per
   mesh beside the single-device step's: one card's virtual mesh, so the
   sharded path's overhead, not scaling. With 2 or more cards visible the
   phase runs again on distinct cards (``mesh_cards``); otherwise a line
   says it did not run and why (neither a pass nor a failure).
17. multihost: two processes of the CLI joined through
   ``GDIET_COORDINATOR`` (gloo, a free local port), both on ``cuda:0``,
   each mapping half of ``tests/data/reads.fq`` with its own counts reset
   before and read after (the SR kernels launched, no plain version): both
   exit 0 and log a group of 2, and their records concatenated equal
   ``golden.sam``.
18. profile: the SE CLI with ``-v 4`` on the main phase's 10,016 reads:
   the four five-stage ``[PROFILING]`` rows (re-run estimates of
   ``staged_times``) each > 0 ns, and the SAM equal to the run without
   ``-v 4``; counts reset just before and read just after the ``-v 4``
   run (the SR kernels launched, no plain version).
19. mesh_lr (after kernel_vote_lr): one HiFi batch (256 reads, the lr
   phase's recipe and budgets) through a (2, 2) virtual mesh of
   ``cuda:0``: the front's packed meta and the SAM equal the single-device
   run's; the band, backtrack and vote_lr kernels launched and no plain
   version.
20. kernel_int16 (after ont): each int16 lane-state kernel
   (``extd2_i16``, ``extd2_band_i16``, ``extd2_fold_i16``: two lanes a
   32-bit register, 16x2 DPX) on the DP calls the paths made (the SE, PE
   and generic (256 and 512 lanes) steps' calls, each call of one HiFi
   batch, the ONT batch's (32768, 34048) chunk) and on seeded rows at 112
   (100 bp reads), 128 and 192 lanes and the SE fold call (phase 3's 6,272
   seeded rows): exact against the int32 kernel of its layout and, on the
   SE, PE and generic 512-lane calls and once per HiFi and ONT bucket
   shape (the ONT chunk included, ~2.5 min), against its plain int16
   version; times in turns
   against int32 (median of 5 rounds), bounds (a packed 16x2 operation
   counts as two lane operations), shares, ptxas registers and spills, and
   the 16x2 DPX instructions of each SASS (> 0). Where a route takes int16
   the int16 kernel must not be slower there than int32 (1%). Each
   full-width call also reports how ``extd2_i16.cu`` runs it: its plan
   (``extd2.i16_plan``, i.e. ``extd2.i16_full_plan``: per launch the
   layout of G threads a row and NS slots of 2G lanes, rows a DP warp,
   zero warps) with each layout's
   resident blocks an SM, registers and local bytes, live rows, us per
   live wavefront (the longest row's) and ns per row wavefront. Each
   windowed call also reports how ``extd2_band_i16.cu`` (one candidate over
   a thread-block cluster) runs it: the cluster size
   ``extd2.band_cluster_size`` picks, the resident clusters of that size
   (``cudaOccupancyMaxActiveClusters``), live rows, warps a block, us per
   live wavefront; and the kernel at every cluster size it takes (C = 1, 2,
   4 and, at the ONT width, 8), exact against the int32 kernel and, where
   the call ran it, the plain int16 version (the ONT chunk's plain run
   once, each C held against its stored result), each C timed in turns.
   The fold kernel's launch at 160 lanes: threads (T / 2, the filler and
   the walker warp), shared memory, resident blocks an SM, the helper
   warps' share of the block's warps.
21. prev_band (``--prev DIR`` with an earlier ``extd2_band_i16.cu``, one
   block a candidate): the earlier source and the checkout's on each
   windowed int16 call of the HiFi batch and on the ONT chunk, score and
   dirs exact, timed in turns (earlier, current, current, earlier); the
   checkout's not slower beyond 1%.
22. prev_full (``--prev DIR`` with an earlier ``extd2_i16.cu``, one C entry
   point ``gdiet_extd2_i16`` for every width): the earlier source and the
   checkout's on the SE step's call (160 lanes), the generic step's at 256
   and 512 lanes, the seeded rows at 112, 128 and 192 lanes and the LR
   (512, 1024) bucket's seeded windows (the block route), each on
   preallocated outputs (the checkout's: ``extd2.launch_full_i16``, its
   plan's launches): score and dirs exact, timed in turns (earlier,
   current, current, earlier); the checkout's not slower beyond 1%.
23. prev_vote_lr (``--prev DIR`` with an earlier ``vote_lr.cu``, same C
   entry points, ``vote_tile.cuh`` beside it): the earlier source and the
   checkout's on the HiFi and ONT batches' captured vote calls, both entry
   points on preallocated outputs, outputs exact, device time (torch.profiler)
   and CUDA events in turns; the checkout's device time not longer beyond
   1%.
24. prev_fold_i16 (``--prev DIR`` with an earlier ``extd2_fold_i16.cu``,
   ``dp_pair.cuh`` beside it): the earlier source, the checkout's and
   ``extd2_fold.cu`` on the PE step's captured fold call and the SE fold
   call, score and dirs exact, in turns (int32, earlier, current, current,
   earlier, int32); the checkout's not slower than the earlier beyond 1%.

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
MAIN_BUDGETS = dict(max_read_len=160, seed_budget=32, shift_seed_budget=16, hit_budget=64,
                    dp_frac=0.3125)  # the bench budgets of the main phase
GENERIC_READS = 65536  # one generic mini-batch of 150 bp reads (9.8 Mbp)
GENERIC_DP512_READS = 8192  # reads of the max_read_len 512 DP timing
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


def sr_dp_kernel(L: int, fold: bool) -> str:
    """The DP kernel the short-read step's route launches at Lmax ``L``
    (extd2.route_state_dtype, at the sr preset's scoring)."""
    from gdiet_tpu_torch.ops.extd2 import route_state_dtype

    i16 = route_state_dtype(PARAMS, L, fold=fold) == "int16"
    return ("extd2_fold" if fold else "extd2") + ("_i16" if i16 else "")


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


def dp_bound(inputs, out, L: int, Lt: int | None = None) -> dict:
    """Bound of one DP call of Lmax L and target budget Lt: its inputs (q,
    t, lens, band[, tlens]) read and its score and dirs written once; the
    operations of the lanes its band updates (the live 16-aligned [offs,
    off_ends] span of every wavefront, ``dp.band_geometry``: the same in
    every layout)."""
    from gdiet_tpu_torch.ops import dp

    Lt = Lt or L
    ln, bd = inputs[2], inputs[3]
    tl = inputs[4] if len(inputs) > 4 else None
    offs, off_ends = dp.band_geometry(ln, tl, bd, L + Lt - 1, dp.round16(Lt))
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
           "max_abs_err": err, **dp_bound((q, t, ln, bd), kern_out, L),
           "longest_live_steps": steps,
           "us_per_wavefront_step": times["kernel_ms"] * 1e3 / max(steps, 1),
           "backtrack": bt, "card": card}
    res["share_of_bound"] = res["bound_ms"] / times["kernel_ms"]
    if built:
        res.update(kernel_build_info(built, "extd2"))
    say("kernel", **res)
    return res


# the DP's outputs held against each other (on the card offs and off_ends
# are None: dp.band_geometry gives them)
DP_OUTPUTS = ("scores", "dirs")
BT_OUTPUTS = ("ops", "fin_i", "fin_j")


def check_equal(got, ref, names, what: str) -> int:
    """The outputs of a kernel that ``names`` names (its first ones)
    bit-equal to its plain version's. Returns the largest difference (0)."""
    import torch

    errs = [(0 if torch.equal(a, b) else _max_err(a, b)) if a.shape == b.shape else -1
            for _, a, b in zip(names, got, ref)]
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
           **dp_bound((q, t, ln, bd), kern_out, L),
           "serial_wavefronts": (C + 1) * H,
           "us_per_wavefront_step": times["kernel_ms"] * 1e3 / ((C + 1) * H),
           "backtrack": bt, "card": card}
    res["share_of_bound"] = res["bound_ms"] / times["kernel_ms"]
    if built:
        res.update(kernel_build_info(built, "extd2_fold"))
    say(phase, **res)
    return res


# integer operations per valid column of one row of the vote (the body of
# csrc/vote_scan.cu: the unsigned distance test, the run tests and the run
# update), and the cycles of its dependent chain per column (about six
# dependent integer operations at ~4 cycles each), for the serial floor;
# the long-read round 1 adds the raw target and its unsigned min and max
VOTE_OPS_PER_COLUMN = 12
VOTE_CYCLES_PER_COLUMN = 24
VOTE_LR_OPS_PER_COLUMN = 20
# csrc/vote_lr.cu walks a half 32 columns a step, one scan a step plus one a
# run break; the dependent chain of one scan (counted from the source, not
# measured): five shuffle levels of (q, lane) at ~27 cycles, the exclusive
# shift, the key's shuffle, the distance test and ballot, the first break,
# the carry's two chained shuffles: ~270 cycles
VOTE_LR_STEP_CYCLES = 270


def capture_calls(owner, names, run) -> dict:
    """{name: [(args, kwargs), ...]} of every call of ``owner.<name>`` for
    each name while ``run()`` runs (the calls go through)."""
    seen = {n: [] for n in names}
    orig = {n: getattr(owner, n) for n in names}

    def spy(name):
        def call(*args, **kw):
            seen[name].append((args, kw))
            return orig[name](*args, **kw)
        return call

    for n in names:
        setattr(owner, n, spy(n))
    try:
        run()
    finally:
        for n in names:
            setattr(owner, n, orig[n])
    return seen


def capture_vote(mapper, codes, lens) -> tuple:
    """The (args, kwargs) one fused step hands to ``ops/vote.py::vote_scan``:
    the six halves, vt_distance, vt_threshold, vt_rec_threshold, K."""
    from gdiet_tpu_torch.ops import vote

    seen = capture_calls(vote, ["vote_scan"], lambda: mapper.fused(codes, lens))["vote_scan"]
    check(len(seen) == 1, f"the step made {len(seen)} vote calls")
    return seen[0]


def valid_first(ok) -> bool:
    """Each row's valid columns come first (the precondition of ops/vote.py)."""
    return not bool((ok[:, 1:] & ~ok[:, :-1]).any())


def stream_bytes(fok, rok) -> dict:
    """What any vote must read of a valid-first stream: each row's valid
    flags up to its strands' ends (one invalid flag after the last valid
    one in each half, unless the half is full) and 12 bytes (key and
    position) per valid column; and the longest row's walked columns (its
    valid columns and one invalid column per half), the serial chain."""
    A = fok.shape[1]
    nf, nr = fok.sum(1), rok.sum(1)
    flags = int((nf + 1).clamp(max=A).sum() + (nr + 1).clamp(max=A).sum())
    valid = int(nf.sum() + nr.sum())
    return {"flag_bytes": flags, "valid_columns": valid, "stream_bytes": flags + 12 * valid,
            "longest_row_columns": int((nf + nr).max()) + 2 if len(nf) else 0}


def rounds_ms(fn, reps: int | None = None) -> float:
    """Median over KERNEL_ROUNDS rounds of ``reps`` (KERNEL_REPS) calls,
    CUDA events."""
    import torch

    reps = reps or KERNEL_REPS
    torch.cuda.synchronize()
    ms = []
    for _ in range(KERNEL_ROUNDS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1) / reps)
    return float(np.median(ms))


def device_ms(fn, kernel: str):
    """The device time of one launch of the kernel whose name contains
    ``kernel``, from a torch.profiler trace of KERNEL_REPS calls of ``fn``
    (the kernel's own time, whatever the host's enqueue rate); None where
    the trace shows no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without the kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(KERNEL_REPS):
                fn()
            torch.cuda.synchronize()
        us = [getattr(ev, "device_time", 0) or getattr(ev, "cuda_time", 0)
              for ev in prof.events() if kernel in ev.name]
        if us and all(us):
            return float(np.mean(us)) / 1e3
    return None


def host_us(fn) -> float:
    """Host microseconds per call of ``fn`` (enqueue only), over
    KERNEL_REPS calls."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(KERNEL_REPS):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / KERNEL_REPS
    torch.cuda.synchronize()
    return us


def blocks_per_sm(registers: int, shared_bytes: int, threads: int = 32) -> dict:
    """Resident blocks per SM of a launch shape: by registers (65,536 per SM,
    allocated per warp in units of 256), by shared memory (233,472 bytes
    per SM, 1 KB reserved per block) and the limit of 32 blocks."""
    warps = -(-threads // 32)
    by_regs = 65536 // (warps * -(-registers * 32 // 256) * 256)
    by_smem = 233472 // (shared_bytes + 1024)
    return {"by_registers": by_regs, "by_shared_memory": by_smem,
            "blocks_per_sm": min(32, by_regs, by_smem)}


def prev_vote_scan(lib, keys, qpos, valid, strand, dist, thr, rec, K: int) -> dict:
    """The earlier vote kernel of ``--prev`` (its C entry point reads the
    concatenated stream)."""
    import torch

    from gdiet_tpu_torch.ops import extd2, vote

    B, M = keys.shape
    out = {n: torch.empty((B, K) if n.startswith("k_") else (B,),
                          dtype=torch.int64 if n.endswith("target") else torch.int32,
                          device=keys.device) for n in vote.OUTPUTS}
    rc = lib.gdiet_vote_scan(keys.data_ptr(), qpos.data_ptr(), valid.data_ptr(),
                             strand.data_ptr(), dist.data_ptr(), thr.data_ptr(), rec.data_ptr(),
                             *(out[n].data_ptr() for n in vote.OUTPUTS), B, M, K,
                             extd2._stream(keys.device))
    check(rc == 0, f"the earlier vote_scan failed: CUDA error {rc}")
    return out


def vote_vs_plain(call, K: int, cuda: bool, what: str, prev=None) -> dict:
    """The vote kernel (halves in place) against the plain
    loop on their concatenation, on one captured stream with K slots: all
    11 outputs exact; times as kernel_vs_plain's (the plain loop one run);
    the time of building the concatenated stream, which the step paid
    before this kernel read the halves in place; the bound (stream_bytes
    plus the per-read inputs and the outputs over HBM bandwidth, or the
    valid columns' operations over the int32 rate), the whole-stream bound
    it (B*M*13 stream bytes) once beside it, and the serial floor (the
    longest row's walked columns x the cycles of one column's chain). With
    ``prev`` (the earlier library): that source on the concatenated stream, in
    turns with this one (earlier, current, current, earlier), outputs
    equal."""
    from gdiet_tpu_torch.ops import vote
    from gdiet_tpu_torch.pipeline.device_step import vote_scan as plain

    args, _ = call
    halves, per_row = args[:6], args[6:9]
    fok, rok = halves[2], halves[5]
    check(valid_first(fok) and valid_first(rok),
          f"the captured stream of {what} is not valid-first")
    concat = vote.concat_stream(*halves)
    got, ref, times = kernel_vs_plain(
        lambda: vote.vote_scan(*halves, *per_row, K),
        lambda: plain(*concat, *per_row, K), cuda, plain_runs=1)
    err = check_equal([got[n] for n in vote.OUTPUTS], [ref[n] for n in vote.OUTPUTS],
                      vote.OUTPUTS, f"vote_scan on {what} (K {K})")
    B, A = fok.shape
    M = 2 * (A + 1)
    sb = stream_bytes(fok, rok)
    io_bytes = B * 16 + B * K * 24 + B * 28  # per-read inputs; slots; the rest
    res = {"what": what, "B": B, "M": M, "K": K, **times, "max_abs_err": err,
           **bound(sb["stream_bytes"] + io_bytes, float(sb["valid_columns"] * VOTE_OPS_PER_COLUMN)),
           **sb, "bound_ms_whole_stream": (B * M * 13 + M * 4 + io_bytes) / HBM_BYTES_PER_S * 1e3,
           "serial_floor_ms": sb["longest_row_columns"] * VOTE_CYCLES_PER_COLUMN / SM_CLOCK_HZ * 1e3,
           "rows_full": int((ref["out_len"] == K).sum()),
           "rows_recovery": int(((ref["out_len"] == 0) & (ref["r_score"] > 0)).sum())}
    res["share_of_bound"] = res["bound_ms"] / times["kernel_ms"]
    if cuda:
        res["concat_ms"] = rounds_ms(lambda: vote.concat_stream(*halves))
        res["device_ms"] = device_ms(lambda: vote.vote_scan(*halves, *per_row, K), "vote_scan_kernel")
        res["wrapper_host_us"] = host_us(lambda: vote.vote_scan(*halves, *per_row, K))
        if res["device_ms"]:
            res["device_share_of_bound"] = res["bound_ms"] / res["device_ms"]
    if prev is not None:
        old = prev_vote_scan(prev, *concat, *per_row, K)
        err_prev = check_equal([old[n] for n in vote.OUTPUTS], [got[n] for n in vote.OUTPUTS],
                               vote.OUTPUTS, f"the earlier vote_scan on {what} (K {K})")
        def earlier():
            return prev_vote_scan(prev, *concat, *per_row, K)

        def current():
            return vote.vote_scan(*halves, *per_row, K)

        turns = [rounds_ms(f) for f in (earlier, current, current, earlier)]
        dev = [device_ms(f, "vote_scan_kernel") for f in (earlier, current, current, earlier)]
        old_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        res["earlier_source"] = {"earlier_ms": old_ms, "current_ms": new_ms,
                                 "speedup": old_ms / new_ms, "turns_ms": turns,
                                 "earlier_with_concat_ms": old_ms + res["concat_ms"],
                                 "device_turns_ms": dev, "max_abs_err": err_prev}
        if None not in dev:
            old_d, new_d = (dev[0] + dev[3]) / 2, (dev[1] + dev[2]) / 2
            res["earlier_source"].update(earlier_device_ms=old_d, current_device_ms=new_d,
                                         device_speedup=old_d / new_d)
    return res


def phase_kernel_vote(device, card: str, n_main: int = BENCH_B,
                      n_generic: int = GENERIC_READS, built=None, prev=None) -> dict:
    """The vote kernel against the plain loop on captured hit streams: one
    SE batch of the main phase (bench budgets, M = 130, K = 2) and one
    generic batch (the mapper's default budgets, A = 2048, M = 4,098) at
    K = 2 and K = 20. With ``built``: ptxas registers and spills. With
    ``prev`` (the earlier vote_scan library): that source timed in turns."""
    import torch

    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    cuda = torch.device(device).type == "cuda"
    genome, _, _, reads = bench_workload(max(n_main, n_generic))
    io_, mo = sr_options()
    mi = build_index([("chr1", genome)], io_, device)
    runs = []
    main = ShortReadMapper(mi, mo, device=device, **MAIN_BUDGETS)
    codes, lens = main.native.encode_batch([r.seq for r in reads[:n_main]], 160)
    call = capture_vote(main, codes, lens)
    runs.append(vote_vs_plain(call, 2, cuda, "the main phase's batch", prev))
    del call
    generic = ShortReadMapper(mi, mo, device=device)
    codes, lens = generic.native.encode_batch([r.seq for r in reads[:n_generic]], generic.Lmax)
    call = capture_vote(generic, codes, lens)
    check(call[0][0].shape[1] == generic.fused.cfg.A, "the generic stream's width")
    for K in (2, 20):
        runs.append(vote_vs_plain(call, K, cuda, "a generic batch", prev))
    del call
    out = {"runs": runs, "card": card}
    if built and built["vote_scan"][2]:  # a build taken from _build/ has no ptxas log
        out["ptxas"] = ptxas_info(built["vote_scan"][2])
        regs = next(iter(out["ptxas"].values()))["registers"]
        # the launch shape: 32 threads, the tile (3,456 bytes) and 12-byte slots
        out["occupancy"] = {f"K={K}": blocks_per_sm(regs, 3456 + K * 32 * 12) for K in (2, 20)}
    say("kernel_vote", **out)
    return out


def build_prev(prev: pathlib.Path) -> dict:
    """``--prev DIR``: the earlier sources in DIR among extd2.cu,
    extd2_fold.cu, vote_lr.cu, extd2_fold_i16.cu (same C entry points as
    the checkout's; the headers they include beside them), vote_scan.cu
    (the earlier entry point, the concatenated stream),
    extd2_band_i16.cu (the earlier entry point, one block a candidate: the
    checkout's arguments without the cluster size) and extd2_i16.cu (its
    one entry point for every width, the int32 layout's arguments), each built
    by its own nvcc, all started together, beside the checkout's. Returns
    {name: (library, ptxas log, path)}."""
    import ctypes
    import hashlib

    from gdiet_tpu_torch.ops import extd2

    build = extd2.BUILD_DIR / ("prev_" + hashlib.sha256(str(prev.resolve()).encode())
                               .hexdigest()[:12])
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("extd2", "extd2_fold", "vote_scan", "extd2_band_i16", "extd2_i16", "vote_lr",
                 "extd2_fold_i16"):
        if not (prev / f"{name}.cu").exists():
            continue
        so = build / f"{name}.so"
        cmd = [extd2._nvcc(), *extd2.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
               str(prev / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    out = {}
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"nvcc failed on the earlier {name}.cu:\n{log}")
        if name == "vote_scan":  # the earlier entry point
            lib = ctypes.CDLL(str(so))
            lib.gdiet_vote_scan.restype = ctypes.c_int
            lib.gdiet_vote_scan.argtypes = [P] * 18 + [I64] * 2 + [I] + [P]
        elif name in ("extd2_band_i16", "extd2_i16"):  # the int32 layout's arguments
            lib = ctypes.CDLL(str(so))
            fn = getattr(lib, f"gdiet_{name}")
            fn.restype = ctypes.c_int
            fn.argtypes = extd2._DP_ARGS[name[:-4]]
        else:
            lib = extd2.bind(so, name)
        out[name] = (lib, log, so)
    return out


def phase_prev(libs: dict, card: str, source: str) -> dict:
    """The earlier extd2.cu and extd2_fold.cu (``build_prev``), each timed
    in turns against the checkout's source on the kernel phases' inputs
    (earlier, current, current, earlier; each a median of KERNEL_ROUNDS
    rounds of KERNEL_REPS launches, CUDA events); the two sources' outputs
    must be equal (exact)."""
    import torch

    from gdiet_tpu_torch.ops import extd2

    out = {}
    for tag, name, N, fold in (("extd2", "extd2", KERNEL_SHAPE["N"], False),
                               ("extd2_fold", "extd2_fold", KERNEL_SHAPE["N"], True),
                               ("extd2_fold_pe", "extd2_fold", pe_dp_rows(PE_PAIRS), True)):
        if name not in libs:
            continue
        Q, T, lens, band = dp_pairs(N, KERNEL_SHAPE["L"], KERNEL_SHAPE["qlen"])
        q, t, ln, bd = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
        L = KERNEL_SHAPE["L"]

        def fn():
            return extd2.extd2_batch(q, t, ln, bd, PARAMS, L, fold=fold)

        cur = extd2._library(name)
        for _ in range(3):
            new_out = fn()
        extd2._libs[name] = libs[name][0]
        try:
            for _ in range(3):
                old_out = fn()
            err = check_equal(old_out, new_out, DP_OUTPUTS, f"{tag}: earlier and current sources")
            times = []
            for lib in (libs[name][0], cur, cur, libs[name][0]):
                extd2._libs[name] = lib
                times.append(rounds_ms(fn))
        finally:
            extd2._libs[name] = cur
        old_ms, new_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        out[tag] = {"rows": N, "earlier_ms": old_ms, "current_ms": new_ms,
                    "speedup": old_ms / new_ms, "turns_ms": times, "max_abs_err": err}
    dp_libs = [n for n in ("extd2", "extd2_fold") if n in libs]
    out["earlier_ptxas"] = {n: ptxas_info(libs[n][1]) for n in libs if n in ("extd2", "extd2_fold",
                                                                              "vote_scan")}
    out["earlier_sass"] = {n: sass_vi_ops(libs[n][2]) for n in dp_libs}
    say("prev", **out, source=source, card=card)
    return out


def _map_sam(mapper, reads) -> list:
    sam = b"".join(bytes(b) for b in mapper.map_stream_sam(iter([reads])))
    return sam.decode().splitlines()


def sr_counts_reset() -> None:
    """Zero the launch counts of the SR/PE path's kernels (DP, vote,
    backtrack) and the call counts of their plain versions."""
    from gdiet_tpu_torch.ops import dp, dp_fold, extd2, vote
    from gdiet_tpu_torch.pipeline import device_step

    for c in (extd2.launches, extd2.fold_launches, extd2.backtrack_launches,
              extd2.i16_launches, extd2.fold_i16_launches,
              vote.launches, dp.calls, dp_fold.calls, device_step.backtrack_calls,
              device_step.vote_calls):
        c.reset()


def sr_counts(what: str, cuda: bool, dp_kernel: str | None = None) -> dict:
    """The SR/PE kernels' launches and their plain versions' calls since
    the last reset; on the card every kernel must have run and no plain
    version: the DP only as the step's routes take it (sr_dp_kernel at any
    width, folded or not), with ``dp_kernel`` that one alone."""
    from gdiet_tpu_torch.ops import dp, dp_fold, extd2, vote
    from gdiet_tpu_torch.pipeline import device_step

    n = {"extd2_launches": extd2.launches.n, "extd2_i16_launches": extd2.i16_launches.n,
         "extd2_fold_i16_launches": extd2.fold_i16_launches.n,
         "extd2_fold_launches": extd2.fold_launches.n,
         "dp_launches": (extd2.launches.n + extd2.i16_launches.n + extd2.fold_launches.n
                         + extd2.fold_i16_launches.n),
         "plain_dp_calls": dp.calls.n + dp_fold.calls.n,
         "vote_launches": vote.launches.n, "plain_vote_calls": device_step.vote_calls.n,
         "backtrack_launches": extd2.backtrack_launches.n,
         "plain_backtrack_calls": device_step.backtrack_calls.n}
    if cuda:
        routes = ({dp_kernel} if dp_kernel else
                  {sr_dp_kernel(L, f) for L in (128, 160, 192, 256, 512) for f in (False, True)})
        check(sum(n[f"{k}_launches"] for k in routes) == n["dp_launches"],
              f"{what} launched DP kernels off its routes {sorted(routes)}: {n}")
        for kern in ("dp", "vote", "backtrack"):
            check(n[f"{kern}_launches"] > 0, f"{what} launched no {kern} kernel")
            check(n[f"plain_{kern}_calls"] == 0,
                  f"{what} called the plain {kern} {n[f'plain_{kern}_calls']} times")
    return n


def regs_to_sam(mapper, recs, results) -> list:
    """SAM records of ``map_batch`` regs, as the mapper's Python writer
    (the generic writer's formatting) writes them."""
    return b"".join(mapper._regs_to_sam(rec, regs, 0)
                    for rec, regs in zip(recs, results)).decode().splitlines()


def phase_golden(device) -> dict:
    """The golden SR fixtures through ``map_stream_sam`` (the native
    finish) and ``map_batch`` (regs, written by ``io/sam.py``), and
    ``golden_split.sam`` through the CLI (``-I 40k --split-prefix``): each
    byte-equal to the reference binary's records."""
    import tempfile

    from gdiet_tpu_torch import cli
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.io.fastx import read_fastx
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper
    from gdiet_tpu_torch.testing import sam_body

    out = {}
    sr_counts_reset()
    for ref, reads, golden, pattern, lmax in (
            ("ref.fa", "reads.fq", "golden.sam", "10", 256),
            ("ref2.fa", "reads2.fq", "golden2_10.sam", "10", 512),
            ("ref2.fa", "reads2.fq", "golden2_1110.sam", "1110", 512),
            ("ref2.fa", "reads2.fq", "golden2_11.sam", "11", 512),
            ("ref2.fa", "reads2.fq", "golden2_110.sam", "110", 512)):
        io_, mo = sr_options(pattern)
        mi = build_index([(r.name, r.seq) for r in read_fastx(str(DATA / ref))], io_, device)
        mapper = ShortReadMapper(mi, mo, max_read_len=lmax, device=device)
        recs = list(read_fastx(str(DATA / reads)))
        gold = sam_body(DATA / golden)
        for how, mine in (("map_stream_sam", _map_sam(mapper, recs)),
                          ("map_batch", regs_to_sam(mapper, recs, mapper.map_batch(recs)))):
            same = sum(a == b for a, b in zip(mine, gold))
            check(mine == gold, f"{golden} through {how}: {same}/{len(gold)} records "
                  f"equal ({len(mine)} produced)")
        out[golden] = len(gold)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "split.sam"
        check(cli.main(["--device", device, *PE_ARGS, "-I", "40k", "--split-prefix",
                        str(pathlib.Path(tmp) / "sp"), "-o", str(path), str(DATA / "ref2.fa"),
                        str(DATA / "reads2.fq")]) == 0, "the --split-prefix CLI failed")
        mine, gold = sam_body(path), sam_body(DATA / "golden_split.sam")
        same = sum(a == b for a, b in zip(mine, gold))
        check(mine == gold, f"golden_split.sam: {same}/{len(gold)} records equal "
              f"({len(mine)} produced)")
        out["golden_split.sam"] = len(gold)
    counts = sr_counts("the golden SR runs", torch_cuda(device))
    say("golden", records=out, identical=True, ways=["map_stream_sam", "map_batch", "cli"],
        **counts)
    return out


def torch_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


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
    from gdiet_tpu_torch.ops import dp
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
    mapper = ShortReadMapper(mi, mo, device=device, **MAIN_BUDGETS)
    batches = [reads[i * B:(i + 1) * B] for i in range(n_timed + 1)]

    # ---- the main path: counts reset just before, read just after ----
    sr_counts_reset()
    sam = _map_sam(mapper, batches[0])  # warm-up batch
    warm = dict(mapper.stats)
    t0 = time.perf_counter()
    for blob in mapper.map_stream_sam(iter(batches[1:])):
        sam += bytes(blob).decode().splitlines()
    sync()
    wall = time.perf_counter() - t0
    dp_kernel = sr_dp_kernel(MAIN_BUDGETS["max_read_len"], False)
    counts = sr_counts("the main path", cuda, dp_kernel)
    launches, plain_calls = counts[f"{dp_kernel}_launches"], dp.calls.n
    stats = mapper.stats
    if cuda:
        check(launches > 0, f"the main path launched no {dp_kernel} kernel")
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
    step, dp_call = step_dp_check(mapper, codes, lens, fold=False)
    # ---- the wider retry tier (A = 2,048, dp_frac 1.0) on one call of
    # retry_batch reads, after a first call that builds it ----
    retry_ms = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        mapper._retry_batch_regs(reads[:mapper.retry_batch])
        sync()
        retry_ms.append((time.perf_counter() - t0) * 1e3)
    res = {"reads": n_reads, "timed_reads": B * n_timed, "batch": B,
           "reads_per_s": B * n_timed / wall, "timed_wall_s": wall,
           "index_build_s": index_s,
           "fallback_reads": warm["fallback_reads"] + stats["fallback_reads"],
           "retried_reads": warm.get("retried_reads", 0) + stats.get("retried_reads", 0),
           "dp_kernel": dp_kernel, **counts, **step,
           "mapped_reads": len(mapped), "mapped_at_origin": near / len(mapped),
           "unmapped_reads": len(unmapped),
           "unmapped_checked_by_oracle": min(len(unmapped), N_UNMAPPED_ORACLE),
           "oracle_reads_equal": n_or,
           "phase_ms": phases, "retry_tier_call_ms": retry_ms[1],
           "retry_tier_first_call_ms": retry_ms[0], "card": card}
    say("main", **res)
    res["dp_calls"] = [dp_call]  # for kernel_int16
    return res


def write_fastx(dirpath: pathlib.Path, genome: str, reads) -> tuple:
    """The genome as FASTA and the reads as FASTQ under ``dirpath``."""
    fa, fq = dirpath / "genome.fa", dirpath / "reads.fq"
    fa.write_text(">chr1\n" + genome + "\n")
    with open(fq, "w") as f:
        f.writelines(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n" for r in reads)
    return fa, fq


def strip_tags(line: str, tags=("MD:Z:", "cs:Z:")) -> str:
    return "\t".join(f for f in line.split("\t") if not f.startswith(tags))


def paf_agrees(paf: list, sam: list) -> int:
    """PAF lines against the SAM's mapped records, in order: query name,
    strand, target, 0-based start, MAPQ and the CIGAR without its soft
    clips (cg:Z). Returns the lines checked."""
    import re

    mapped = [f for f in (l.split("\t") for l in sam) if not int(f[1]) & 4]
    check(len(paf) == len(mapped), f"{len(paf)} PAF lines for {len(mapped)} mapped records")
    for line, f in zip(paf, mapped):
        p = line.split("\t")
        cg = next(t[5:] for t in p[12:] if t.startswith("cg:Z:"))
        want = (f[0], "-" if int(f[1]) & 16 else "+", f[2], int(f[3]) - 1, f[4],
                re.sub(r"^\d+S|\d+S$", "", f[5]))
        check((p[0], p[4], p[5], int(p[7]), p[11], cg) == want,
              f"PAF line {line[:80]!r} disagrees with SAM record {f[:6]}")
    return len(paf)


def dp_at_size(mapper, codes, lens, cuda: bool, n_plain: int = 1024) -> tuple:
    """One batch's DP inputs, as the step hands them to ``extd2_batch``:
    the DP kernel of its route (in the lane state the call takes) and the
    backtrack kernel timed on all of them (as
    kernel_vs_plain times a kernel), and both held against their plain
    versions on the first ``n_plain`` rows (exact), whose plain times are
    reported for those rows. Returns (the report, the captured call)."""
    from gdiet_tpu_torch.ops import dp, extd2
    from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

    seen = capture_calls(extd2, ["extd2_batch"], lambda: mapper.fused(codes, lens))["extd2_batch"]
    check(len(seen) == 1 and not seen[0][1].get("fold"), "the step made no unfolded DP call")
    (q, t, ln, bd, params, L), kw = seen[0]
    sd = kw.get("state_dtype", "int32")
    check(sd == extd2.route_state_dtype(params, L),
          f"the step's DP call at Lmax {L} has lane state {sd}")
    out, _, times = kernel_vs_plain(lambda: extd2.extd2_batch(q, t, ln, bd, params, L,
                                                              state_dtype=sd),
                                    lambda: None, cuda, plain_runs=1)
    bt, _, bt_times = kernel_vs_plain(lambda: extd2.backtrack_band(out[1], ln, ln, bd, L, L),
                                      lambda: None, cuda, plain_runs=1)
    n = min(n_plain, int(q.shape[0]))
    sub = (q[:n], t[:n], ln[:n], bd[:n])
    t0 = time.perf_counter()
    plain = dp.extd2_batch(*sub, params, L, state_dtype=sd)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_equal(extd2.extd2_batch(*sub, params, L, state_dtype=sd), plain, DP_OUTPUTS,
                      f"the {sd} full-width DP at Lmax {L} on the step's DP inputs")
    t0 = time.perf_counter()
    bt_plain = backtrack_antidiag(plain[1], ln[:n], bd[:n], L)
    bt_plain_ms = (time.perf_counter() - t0) * 1e3
    bt_err = check_equal(extd2.backtrack_band(plain[1], ln[:n], ln[:n], bd[:n], L, L),
                         bt_plain, BT_OUTPUTS, f"backtrack_band at Lmax {L}")
    res = {"Lmax": L, "lanes": dp.round16(L), "rows": int(q.shape[0]), "state_dtype": sd,
           "live_rows": int((ln > 0).sum()), "kernel_ms": times["kernel_ms"],
           "kernel_ms_rounds": times["kernel_ms_rounds"], **dp_bound((q, t, ln, bd), out, L),
           "plain_rows": n, "plain_ms_on_plain_rows": plain_ms, "max_abs_err": err,
           "backtrack": {"kernel_ms": bt_times["kernel_ms"], **walk_report(bt, bt_times["kernel_ms"],
                                                                          int(q.shape[0])),
                         "plain_ms_on_plain_rows": bt_plain_ms, "max_abs_err": bt_err}}
    res["share_of_bound"] = res["bound_ms"] / times["kernel_ms"]
    return res, seen[0]


def phase_generic(device, n_reads: int, card: str) -> dict:
    """The generic per-record path at size: the bench recipe's reads (one
    mini-batch) through the CLI on a prebuilt index, as SAM (``-a``, the
    fast path), SAM with ``--MD --cs`` and PAF (``-c``), both through the
    generic writer. Checks: the --MD --cs records without those tags equal
    the fast path's; the first reads' records equal the scalar oracle's,
    tags included; every PAF line agrees with its SAM record; each run
    launched the vote, DP and backtrack kernels and no plain version. Then
    one generic batch's per-phase device times, its host finish (regs) and
    SAM writing, and the peak device memory per read."""
    import tempfile

    import torch

    from gdiet_tpu_torch import cli, config, runtime
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper
    from gdiet_tpu_torch.testing import sam_body

    cuda = torch_cuda(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    genome, _, _, reads = bench_workload(n_reads)
    io_, mo = sr_options()
    mo.flag |= (config.MM_F_OUT_SAM | config.MM_F_CIGAR | config.MM_F_OUT_MD
                | config.MM_F_OUT_CS)  # -a --MD --cs
    args = [a for a in PE_ARGS if a != "-a"]
    res = {"reads": n_reads, "bases": n_reads * READ_LEN}
    generic_calls = []
    run_generic = runtime.run_generic

    def spy(*a, **kw):
        generic_calls.append(1)
        return run_generic(*a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        _, fq = write_fastx(tmp, genome, reads)
        t0 = time.perf_counter()
        mi = build_index([("chr1", genome)], io_, device)
        sync()
        res["index_build_s"] = time.perf_counter() - t0
        idx = tmp / "genome.gdi.npz"
        mi.save(str(idx))
        outs, walls, counts = {}, {}, {}
        runtime.run_generic = spy
        try:
            for tag, opts, generic in (("fast", ["-a"], False),
                                       ("md_cs", ["-a", "--MD", "--cs"], True),
                                       ("paf", ["-c"], True)):
                path = tmp / f"{tag}.out"
                n0 = len(generic_calls)
                sr_counts_reset()
                t0 = time.perf_counter()
                check(cli.main(["--device", device, *opts, *args, "-o", str(path), str(idx),
                                str(fq)]) == 0, f"the {tag} CLI run failed")
                sync()
                walls[tag] = time.perf_counter() - t0
                check((len(generic_calls) > n0) == generic,
                      f"the {tag} run {'missed' if generic else 'took'} the generic writer")
                counts[tag] = sr_counts(f"the {tag} CLI run", cuda)
                outs[tag] = sam_body(path)
        finally:
            runtime.run_generic = run_generic
    check([strip_tags(l) for l in outs["md_cs"]] == outs["fast"],
          "the --MD --cs records without their tags differ from the fast path's")
    check(sum("\tMD:Z:" in l for l in outs["md_cs"]) > 0.9 * n_reads, "MD tags missing")
    n_or = min(N_ORACLE, n_reads)
    mapper = ShortReadMapper(mi, mo, device=device)
    oracle = b"".join(mapper._oracle_sam(r, 0) for r in reads[:n_or]).decode().splitlines()
    names = {r.name for r in reads[:n_or]}
    mine = [l for l in outs["md_cs"] if l.split("\t", 1)[0] in names]
    check(mine == oracle, "the first reads' --MD --cs records differ from the scalar oracle's")
    n_paf = paf_agrees(outs["paf"], outs["fast"])

    # ---- one generic batch: per-phase device times, host finish, writer,
    # peak device memory ----
    codes, lens = mapper.native.encode_batch([r.seq for r in reads], mapper.Lmax)
    results = []
    sync()
    base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    phases = per_phase(mapper, codes, lens, cuda, lambda dev, fetched: results.append(
        mapper._finish((reads, codes, lens, np.zeros(n_reads, bool), np.arange(n_reads), dev),
                       fetched)))
    peak = (torch.cuda.max_memory_allocated() - base) if cuda else 0
    t0 = time.perf_counter()
    lines = regs_to_sam(mapper, reads, results[0])
    phases["sam_writer"] = (time.perf_counter() - t0) * 1e3
    check(lines == outs["md_cs"], "the batch's records differ from the CLI run's")
    # the route's DP kernel and the backtrack at the generic widths: 256
    # lanes (this batch) and 512 (max_read_len 512, as the golden2 fixtures
    # map)
    size256, call256 = dp_at_size(mapper, codes, lens, cuda)
    stats, cfg = mapper.stats, mapper.fused.cfg
    del mapper, results
    wide = ShortReadMapper(mi, mo, max_read_len=512, device=device)
    n512 = min(n_reads, GENERIC_DP512_READS)
    c512, l512 = wide.native.encode_batch([r.seq for r in reads[:n512]], 512)
    size512, call512 = dp_at_size(wide, c512, l512, cuda)
    res.update({
        "reads_per_s": {tag: n_reads / w for tag, w in walls.items()}, "wall_s": walls,
        "records": len(outs["md_cs"]), "paf_lines_checked": n_paf,
        "oracle_reads_equal": n_or, "launches_and_plain_calls": counts,
        "batch_phase_ms": phases, "fallback_reads": stats["fallback_reads"],
        "retried_reads": stats.get("retried_reads", 0),
        "hit_budget": cfg.A, "vote_columns": 2 * (cfg.A + 1),
        "peak_device_bytes": peak, "peak_device_bytes_per_read": peak / n_reads,
        "dp_at_size": [size256, size512], "card": card})
    say("generic", **res)
    res["dp_calls"] = [call256, call512]  # for kernel_int16
    return res


def phase_api(device, card: str) -> dict:
    """``Aligner(device=...)`` on ``ref.fa``, one ``map`` call per read of
    ``reads.fq``: every alignment's contig, 1-based start, strand, CIGAR
    (the SAM CIGAR without soft clips) and MAPQ equal the golden records'."""
    import re

    from gdiet_tpu_torch.api import Aligner, fastx_read
    from gdiet_tpu_torch.testing import sam_body

    gold: dict = {}
    for f in (l.split("\t") for l in sam_body(DATA / "golden.sam")):
        if not int(f[1]) & 4:
            gold.setdefault(f[0], []).append(
                (f[2], int(f[3]), -1 if int(f[1]) & 16 else 1,
                 re.sub(r"^\d+S|\d+S$", "", f[5]), int(f[4])))
    sr_counts_reset()
    a = Aligner(str(DATA / "ref.fa"), device=device, preset="sr", pattern="10",
                max_seeds=2.0, best_n=1, bw_frac=0.05, bw_min=150, bw_max=200,
                min_cnt=0.95, rec_threshold_frac=0.3, min_dp_max=100, AF_max_loc=2)
    t0 = time.perf_counter()
    n_reads = n_aln = 0
    for name, seq, _ in fastx_read(str(DATA / "reads.fq")):
        hits = [(h.ctg, h.r_st + 1, h.strand, h.cigar_str, h.mapq)
                for h in a.map(seq, cs=True, MD=True)]
        check(hits == gold.get(name, []), f"Aligner on {name}: {hits} != {gold.get(name)}")
        n_reads += 1
        n_aln += len(hits)
    wall = time.perf_counter() - t0
    counts = sr_counts("the Aligner", torch_cuda(device))
    res = {"reads": n_reads, "alignments": n_aln, "seconds": wall,
           "ms_per_map_call": wall * 1e3 / n_reads, **counts, "card": card}
    say("api", **res)
    return res


def dp_call_check(call, fold: bool, what: str) -> dict:
    """One ``extd2_batch`` call of the SR/PE step, as captured, through the
    DP kernel and its plain version at the call's shapes, then the DP
    outputs through the backtrack kernel and the plain walk: all exact."""
    from gdiet_tpu_torch.ops import dp, dp_fold, extd2
    from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

    (q, t, ln, bd, params, L), kw = call
    check(bool(kw.get("fold")) == fold,
          f"{what} made no {'folded' if fold else 'unfolded'} DP call")
    check(tuple(params) == PARAMS, f"{what}'s scoring {params} is not {PARAMS}")
    sd = kw.get("state_dtype", "int32")
    check(sd == extd2.route_state_dtype(params, L, fold=fold),
          f"{what}'s DP call has lane state {sd}")
    plain = dp_fold.extd2_fold if fold else dp.extd2_batch
    got = extd2.extd2_batch(q, t, ln, bd, PARAMS, L, fold=fold, state_dtype=sd)
    name = ("extd2_fold" if fold else "extd2") + ("_i16" if sd == "int16" else "")
    dp_err = check_equal(got, plain(q, t, ln, bd, PARAMS, L, None, None, sd), DP_OUTPUTS,
                         f"{name} on {what}'s DP inputs")
    bt_err = check_equal(extd2.backtrack_band(got[1], ln, ln, bd, L, L, fold=fold),
                         backtrack_antidiag(got[1], ln, bd, L, fold=fold), BT_OUTPUTS,
                         f"backtrack_band on {what}'s DP outputs")
    return {"step_dp_rows": int(q.shape[0]), "step_dp_live_rows": int((ln > 0).sum()),
            "step_dp_state_dtype": sd, "step_dp_max_abs_err": dp_err,
            "step_backtrack_max_abs_err": bt_err}


def step_dp_check(mapper, codes, lens, fold: bool) -> tuple:
    """One batch's DP inputs, as the step hands them to ``extd2_batch``,
    through ``dp_call_check``. Returns (its report, the captured call)."""
    from gdiet_tpu_torch.ops import extd2

    seen = capture_calls(extd2, ["extd2_batch"], lambda: mapper.fused(codes, lens))["extd2_batch"]
    check(len(seen) == 1, f"the step made {len(seen)} DP calls")
    return dp_call_check(seen[0], fold, "the step"), seen[0]


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
            sr_counts_reset()
            out = pathlib.Path(tmp) / f"{name}.sam"
            check(cli.main(["--device", device, *PE_ARGS, "-o", str(out), *inputs]) == 0,
                  f"PE CLI on {device} (fold {fold}) failed")
            runs[name] = sam_body(out)
            if device == "cuda":
                bt[name] = sr_counts(f"the PE CLI ({name})", True)
            if name == "cuda_fold":
                check(extd2.fold_launches.n + extd2.fold_i16_launches.n > 0,
                      "the PE CLI launched no fold kernel")
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
           "launches_and_plain_calls": bt, "card": card}
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
    counts = ((extd2.launches, extd2.i16_launches), (extd2.fold_launches, extd2.fold_i16_launches),
              (dp.calls,), (dp_fold.calls,))
    sr_counts_reset()
    sam = run(mapper, batches[:1])  # warm-up batch
    first_batch = list(sam)
    warm = dict(mapper.stats)
    t0 = time.perf_counter()
    sam += run(mapper, batches[1:])
    sync()
    wall = time.perf_counter() - t0
    unfold_launches, fold_launches, plain_calls, plain_fold_calls = (sum(c.n for c in cs)
                                                                     for cs in counts)
    pe_counts = sr_counts("the PE path", cuda, sr_dp_kernel(MAIN_BUDGETS["max_read_len"], True))
    if cuda:
        check(fold_launches > 0, "the PE path launched no fold kernel")
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
    sr_counts_reset()
    check(run(unfolded, batches[:1]) == first_batch,
          "the first batch's SAM differs with the fold off")
    unfold_counts = sr_counts("the PE path with the fold off", cuda)

    # ---- per-phase device times of one batch ----
    state = mapper._prepare_pe(batches[1], P)
    sync()
    codes, lens = state[1], state[2]
    phases = per_phase(mapper, codes, lens, cuda, lambda dev, fetched: mapper._finish_pe(
        (*state[:4], dev, *state[5:]), 0, fetched))

    # ---- the fold and backtrack kernels on the DP inputs the step gives them ----
    step, dp_call = step_dp_check(mapper, codes, lens, fold=True)
    res = {"pairs": n_pairs, "timed_pairs": P * n_timed, "batch_pairs": P,
           "pairs_per_s": P * n_timed / wall, "timed_wall_s": wall,
           "fallback_pairs": warm["fallback_reads"] + mapper.stats["fallback_reads"],
           "plain_dp_calls": plain_calls, "plain_fold_calls": plain_fold_calls,
           **pe_counts, "fold_off_launches_and_plain_calls": unfold_counts,
           "pairs_both_mapped": both / n_pairs, "mapped_at_origin": near / len(mapped),
           **step,
           "oracle_pairs_equal": PE_ORACLE, "first_batch_equal_unfolded": True,
           "phase_ms": phases, "card": card}
    say("pe", **res)
    res["dp_calls"] = [dp_call]  # for kernel_int16
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
    (WB 1,536), two lanes per thread: scores and every dirs byte exact;
    the backtrack kernel on those dirs equal to the plain backtrack. The unwindowed (512, 1024) bucket of
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
               **dp_bound((q, t, ln, bd, tl), kern_out, Lmax, Lt),
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
        **dp_bound((q, t, ln, bd, tl), big, Lq4, Lt4), "longest_live_steps": steps,
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
            n0, b0 = extd2.band_i16_launches.n, extd2.backtrack_launches.n
            f0 = extd2.i16_launches.n
            path = pathlib.Path(tmp) / f"{tag}.sam"
            t0 = time.perf_counter()
            check(cli.main(["--device", device, *args, "-o", str(path), *inputs]) == 0,
                  f"LR CLI ({tag}) failed")
            mine, gold = sam_body(path), sam_body(DATA / f"golden_lr_{tag}.sam")
            same = sum(a == b for a, b in zip(mine, gold))
            check(mine == gold, f"golden_lr_{tag}.sam: {same}/{len(gold)} records equal "
                  f"({len(mine)} produced)")
            check(device != "cuda" or (extd2.band_i16_launches.n > n0
                                       and extd2.backtrack_launches.n > b0),
                  f"the LR CLI ({tag}) launched no int16 band or backtrack kernel")
            out[tag] = {"records": len(gold), "seconds": time.perf_counter() - t0,
                        "band_i16_launches": extd2.band_i16_launches.n - n0,
                        "full_width_i16_launches": extd2.i16_launches.n - f0,
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


_STREAM_COLUMN_CALLS = {"n": 0}


def _count_stream_columns() -> None:
    """Count the calls of ``lr_step._stream_columns`` (the plain LR loops'
    column list, which syncs with the host) from here on."""
    from gdiet_tpu_torch.pipeline import lr_step

    f = lr_step._stream_columns
    if getattr(f, "counted", False):
        return

    def counted(*a, **kw):
        _STREAM_COLUMN_CALLS["n"] += 1
        return f(*a, **kw)

    counted.counted = True
    lr_step._stream_columns = counted


def lr_counts_reset() -> None:
    """Zero the launch counts of the LR path's kernels (band, full-width
    DP, backtrack, vote_lr) and the call counts of their plain versions
    (the LR vote loops and ``_stream_columns`` included)."""
    from gdiet_tpu_torch.ops import dp, dp_band, extd2, vote
    from gdiet_tpu_torch.pipeline import device_step, lr_step

    _count_stream_columns()
    _STREAM_COLUMN_CALLS["n"] = 0
    for c in (extd2.band_launches, extd2.launches, extd2.band_i16_launches,
              extd2.i16_launches, extd2.backtrack_launches, vote.lr_launches,
              dp_band.calls, dp.calls, device_step.backtrack_calls, lr_step.vote_calls):
        c.reset()


def lr_counts(what: str, cuda: bool) -> dict:
    """The LR kernels' launches and their plain versions' calls since the
    last reset; on the card the DP (band or full width, in the LR route's
    lane state, int16: the int16 kernels, no int32 one), backtrack and
    vote kernels must have run and no plain version."""
    from gdiet_tpu_torch.ops import dp, dp_band, extd2, vote
    from gdiet_tpu_torch.pipeline import device_step, lr_step

    n = {"band_i16_launches": extd2.band_i16_launches.n,
         "full_width_i16_launches": extd2.i16_launches.n,
         "band_launches": extd2.band_launches.n, "full_width_launches": extd2.launches.n,
         "backtrack_launches": extd2.backtrack_launches.n,
         "vote_lr_launches": vote.lr_launches.n, "plain_band_calls": dp_band.calls.n,
         "plain_dp_calls": dp.calls.n, "plain_backtrack_calls": device_step.backtrack_calls.n,
         "plain_lr_vote_calls": lr_step.vote_calls.n,
         "stream_columns_calls": _STREAM_COLUMN_CALLS["n"]}
    if cuda:
        check(n["band_i16_launches"] + n["full_width_i16_launches"] > 0
              and n["backtrack_launches"] > 0 and n["vote_lr_launches"] > 0,
              f"{what} launched too few kernels: {n}")
        check(n["band_launches"] + n["full_width_launches"] == 0,
              f"{what} launched an int32 DP kernel off its int16 route: {n}")
        plain = {k: v for k, v in n.items() if k.startswith(("plain", "stream")) and v}
        check(not plain, f"{what} called plain versions: {plain}")
    return n


def lr_batch_phases(mapper, batch, sync) -> tuple:
    """Per-phase ms of one batch through ``map_batch`` (a device sync at
    each boundary) and the (args, kwargs) of the DP calls it made."""
    from gdiet_tpu_torch.ops import extd2

    acc: dict = {}
    last = [0.0]

    def mark(name):
        sync()
        now = time.perf_counter()
        acc[name] = acc.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    mapper.mark = mark
    try:
        sync()
        last[0] = time.perf_counter()
        seen = capture_calls(extd2, ["extd2_batch"], lambda: mapper.map_batch(batch))
    finally:
        mapper.mark = None
    return acc, seen["extd2_batch"]


def windowed_calls(seen) -> list:
    """The windowed band DP calls among captured LR DP calls."""
    from gdiet_tpu_torch.ops import dp_band

    return [(a, kw) for a, kw in seen if dp_band.band_shape(
        a[5], kw["Lt"], kw["band_budget"], kw["unroll"])[2] is not None]


def lr_dp_check(seen, what: str) -> dict:
    """The smallest windowed bucket of the DP calls one LR batch made
    (``seen``, as ``lr_batch_phases`` captures them) through
    ``lr_dp_call_check``."""
    windowed = windowed_calls(seen)
    check(bool(windowed), f"{what} made no windowed DP call")
    return lr_dp_call_check(min(windowed, key=lambda c: c[0][5]), what)


def lr_dp_call_check(call, what: str) -> dict:
    """One captured windowed DP call through the band kernel and its plain
    version at the call's shapes, then its dirs through the backtrack
    kernel and the plain walk: exact."""
    from gdiet_tpu_torch.ops import dp_band, extd2
    from gdiet_tpu_torch.pipeline import device_step

    (q, t, ln, bd, params, L), kw = call
    Lt, bb, U, tl = kw["Lt"], kw["band_budget"], kw["unroll"], kw["tlens"]
    sd = kw.get("state_dtype", "int32")
    check(sd == extd2.route_state_dtype(params, L, Lt, band_budget=bb, unroll=U),
          f"{what}'s DP call has lane state {sd}")
    got = extd2.extd2_batch(q, t, ln, bd, params, L, tlens=tl, Lt=Lt, band_budget=bb, unroll=U,
                            state_dtype=sd)
    ref = dp_band.extd2_band(q, t, ln, bd, params, L, tl, Lt, bb, U, sd)
    err = check_equal(got, ref, DP_OUTPUTS, f"{what}'s DP inputs")
    bt_err = check_equal(
        extd2.backtrack_band(got[1], ln, tl, bd, L, Lt, band_budget=bb, unroll=U),
        device_step.backtrack_antidiag(got[1], ln, bd, L, tlens=tl, Lt=Lt,
                                       band_budget=bb, unroll=U),
        BT_OUTPUTS, f"{what}'s backtrack")
    return {"Lmax": L, "Lt": Lt, "rows": int(q.shape[0]), "live_rows": int((ln > 0).sum()),
            "state_dtype": sd, "max_abs_err": err, "backtrack_max_abs_err": bt_err}


def capture_lr_votes(mapper, reads, n_rows: int = 1) -> dict:
    """The (args, kwargs) the long-read front hands to ``ops/vote.py``'s
    ``vote_lr`` and ``vote2_pair`` for one batch: one call of each per data
    row (``n_rows`` under a mesh)."""
    from gdiet_tpu_torch.ops import vote

    lens = np.array([r.l_seq for r in reads], np.int64)
    seen = capture_calls(vote, ["vote_lr", "vote2_pair"],
                         lambda: mapper._dispatch_front(reads, lens))
    check(len(seen["vote_lr"]) == n_rows and len(seen["vote2_pair"]) == n_rows,
          f"the LR front made {len(seen['vote_lr'])} round-1 and "
          f"{len(seen['vote2_pair'])} round-2 vote calls for {n_rows} data rows")
    return seen


def lr_vote_walk(halves, dist) -> dict:
    """The round-1 runs of each half of a captured long-read stream, walked
    on the host as csrc/vote_lr.cu's warps walk them (valid-first halves):
    valid columns per half, run lengths, and each warp's scan iterations
    (one a 32-column step, plus one a run break inside it; the half's first
    column starts its first run without one)."""
    import torch

    from gdiet_tpu_torch import u64

    d = dist.cpu()
    valid, lengths, iters = [], [], []
    for K_, Q_, V_ in (tuple(t.cpu() for t in halves[:3]), tuple(t.cpu() for t in halves[3:])):
        n = V_.sum(1)
        B, nmax = K_.shape[0], int(n.max()) if K_.shape[0] else 0
        fq = torch.zeros(B, dtype=torch.int32)
        ref = torch.zeros(B, dtype=torch.int64)
        start = torch.zeros((B, nmax), dtype=torch.bool)
        for c in range(nmax):
            t, q = K_[:, c], Q_[:, c]
            brk = (c < n) & ((c == 0) | ~u64.ule(t - ref, d))
            start[:, c] = brk
            lt = q < fq
            fq = torch.where(brk | lt, q, fq)
            ref = torch.where(brk | lt, t, ref)
        for b in range(B):
            nb = int(n[b])
            valid.append(nb)
            if nb == 0:
                iters.append(0)
                continue
            st = np.flatnonzero(start[b, :nb].numpy())
            lengths += np.diff(np.append(st, nb)).tolist()
            it = 0
            for c0 in range(0, nb, 32):
                end = min(32, nb - c0)
                br = st[(st >= c0) & (st < c0 + end) & (st > 0)] - c0
                s0 = int(br[-1]) + 1 if len(br) else (1 if c0 == 0 else 0)
                it += len(br) + (s0 < end)
            iters.append(it)
    valid, iters = np.array(valid), np.array(iters)
    return {"halves": len(valid), "valid_per_half_mean": float(valid.mean()),
            "valid_per_half_max": int(valid.max()), "runs": len(lengths),
            "run_len_mean": float(np.mean(lengths)) if lengths else 0.0,
            "run_len_max": int(max(lengths)) if lengths else 0,
            "warp_steps": int(iters.sum()), "warp_steps_max_half": int(iters.max())}


def vote_lr_launch_floor(B: int):
    """The device time of an empty kernel at vote_lr.cu's launch shape (B
    blocks of 64 threads; its entry point gdiet_vote_lr_empty), or None
    where the trace shows none."""
    import ctypes

    import torch

    from gdiet_tpu_torch.ops import extd2

    lib = extd2._library("vote_lr")
    fn = lib.gdiet_vote_lr_empty
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int64, ctypes.c_void_p]

    def empty():
        check(fn(B, torch.cuda.current_stream().cuda_stream) == 0, "the empty kernel failed")

    return device_ms(empty, "vote_lr_empty")


def vote_lr_vs_plain(calls: dict, cuda: bool, what: str) -> dict:
    """Both entry points of csrc/vote_lr.cu (halves in place)
    against the plain loops on the concatenated stream over the columns of
    ``_stream_columns`` (the path's plain version), on one captured batch:
    round 1's 7 outputs and round 2's packed [B, 16] block exact. Times as
    kernel_vs_plain's (the plain loops one run each) and each entry
    point's device time; bounds from this stream (stream_bytes plus
    per-read inputs and outputs, or the valid columns' operations); the
    stream as the kernel's warps walk it (``lr_vote_walk``: valid columns
    per half, run lengths, scan iterations) and the serial floor (the
    longest half's scan iterations x VOTE_LR_STEP_CYCLES; twice that for
    round 2's two windows); the warps each entry point launches; the launch
    floor (an empty kernel's device time at the same launch shape)."""
    from gdiet_tpu_torch.ops import vote
    from gdiet_tpu_torch.pipeline import lr_step

    (a1, _), = calls["vote_lr"]
    (a2, _), = calls["vote2_pair"]
    halves, (ex, dist, cov, K) = a1[:6], a1[6:10]
    lo1, hi1, lo2, hi2 = a2[8:12]
    fok, rok = halves[2], halves[5]
    check(valid_first(fok) and valid_first(rok), f"the captured {what} stream is not valid-first")
    keys, qv, okv, strand = vote.concat_stream(*halves)
    strand = strand.tolist()
    cols = lr_step._stream_columns(fok, rok)
    got1, ref1, t1 = kernel_vs_plain(
        lambda: vote.vote_lr(*halves, ex, dist, cov, K),
        lambda: lr_step._vote_scan_lr(keys, qv, okv, strand, ex, dist, cov, K, cols),
        cuda, plain_runs=1)
    err1 = check_equal([got1[n] for n in vote.LR_OUTPUTS], [ref1[n] for n in vote.LR_OUTPUTS],
                       vote.LR_OUTPUTS, f"vote_lr on {what}")
    got2, ref2, t2 = kernel_vs_plain(
        lambda: vote.vote2_pair(*halves, ex, dist, lo1, hi1, lo2, hi2),
        lambda: lr_step.vote2_packed_pair(keys, qv, okv, strand, ex, dist, lo1, hi1, lo2, hi2,
                                          cols),
        cuda, plain_runs=1)
    err2 = check_equal([got2], [ref2], ("vote2",), f"vote2_pair on {what}")
    B, A = fok.shape
    sb = stream_bytes(fok, rok)
    walk = lr_vote_walk(halves, dist)
    # the longest half's warp: its scan iterations (round 2 scans two windows)
    floor = walk["warp_steps_max_half"] * VOTE_LR_STEP_CYCLES / SM_CLOCK_HZ * 1e3
    ops = float(sb["valid_columns"] * VOTE_LR_OPS_PER_COLUMN)
    r1 = {**t1, "max_abs_err": err1, **bound(sb["stream_bytes"] + B * 20 + B * K * 32 + B * 4, ops),
          "serial_floor_ms": floor, "rows_full": int((ref1["out_len"] == K).sum()),
          "warps": 2 * B if K <= 32 else B}
    r2 = {**t2, "max_abs_err": err2, **bound(sb["stream_bytes"] + B * 32 + B * 64, 2 * ops),
          "serial_floor_ms": 2 * floor, "warps": 2 * B,
          "windows_open": int((hi1 > lo1 + 1).sum() + (hi2 > lo2 + 1).sum()),
          "best_runs": int((ref2[:, 0] > 0).sum() + (ref2[:, 8] > 0).sum())}
    for r, name, fn in ((r1, "vote_lr_kernel",
                         lambda: vote.vote_lr(*halves, ex, dist, cov, K)),
                        (r2, "vote2_pair_kernel",
                         lambda: vote.vote2_pair(*halves, ex, dist, lo1, hi1, lo2, hi2))):
        r["share_of_bound"] = r["bound_ms"] / r["kernel_ms"]
        if cuda:
            r["device_ms"] = device_ms(fn, name)
            r["wrapper_host_us"] = host_us(fn)
            if r["device_ms"]:
                r["device_share_of_bound"] = r["bound_ms"] / r["device_ms"]
    out = {"what": what, "B": B, "M": 2 * (A + 1), "K": K, **sb, "walk": walk,
           "plain_columns_visited": len(cols), "round1": r1, "round2": r2}
    if cuda:
        out["launch_floor_device_ms"] = vote_lr_launch_floor(B)
    return out


def phase_lr(device, n_timed: int, genome_len: int, card: str, B: int = LR_BATCH) -> tuple:
    """The HiFi path at full size: bench.py's lr_stats options and mapper
    budgets, batches of B reads, 1 warm-up + n_timed timed through
    map_stream. Checks: >= 90% of reads mapped, the first reads' SAM equal
    to the scalar oracle's, band, backtrack and vote_lr launches > 0 and no
    plain call (the LR vote loops and ``_stream_columns`` included) in the
    timed window; one batch's per-phase times; one chunk's captured DP
    inputs through the kernels and the plain versions once more, exact.
    Returns (the phase's report, one batch's captured vote calls)."""
    import torch

    from gdiet_tpu_torch import config
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.oracle import longread as olr
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
    results = list(mapper.map_stream(iter(batches[:1])))  # warm-up batch
    lr_counts_reset()
    t0 = time.perf_counter()
    results += list(mapper.map_stream(iter(batches[1:])))
    sync()
    wall = time.perf_counter() - t0
    counts = lr_counts("the LR path", cuda)
    regs = [r for batch in results for r in batch]
    n_mapped = sum(bool(r) for r in regs)
    check(n_mapped >= 0.9 * len(reads), f"only {n_mapped}/{len(reads)} reads mapped")
    mine = [l for rec, rg in zip(reads[:LR_ORACLE], regs) for l in mapper.regs_to_sam_lines(rec, rg)]
    oracle = [l for rec in reads[:LR_ORACLE] for l in mapper.regs_to_sam_lines(
        rec, olr.map_read_lr(mapper.mi.oracle_view(), rec.seq, mo, mapper.mid_occ, rec.name))]
    check(mine == oracle, "SAM of the first reads differs from the scalar oracle's")

    # ---- per-phase times of one batch (a device sync at each boundary) ----
    acc, seen = lr_batch_phases(mapper, batches[1], sync)

    # ---- the kernels on the DP inputs the mapper gives them ----
    step_dp = lr_dp_check(seen, "the LR batch")
    res = {"reads": len(reads), "timed_reads": B * n_timed, "batch": B,
           "reads_per_s": B * n_timed / wall, "timed_wall_s": wall,
           "fallback_reads": mapper.stats["fallback_reads"],
           "host_dp_segments": mapper.stats["host_dp_segments"],
           "mapped_reads": n_mapped, "oracle_reads_equal": LR_ORACLE, **counts,
           "phase_ms": acc, "dp_calls_in_batch": len(seen), "step_dp": step_dp,
           "card": card}
    say("lr", **res)
    res["dp_calls"] = seen  # for kernel_int16
    return res, capture_lr_votes(mapper, batches[1])


def phase_kernel_vote_lr(device, card: str, calls: dict, built=None) -> dict:
    """Both entry points of csrc/vote_lr.cu against the plain LR loops on
    the vote calls captured from one HiFi batch (vote_lr_vs_plain). With
    ``built``: ptxas registers, static shared memory and spills."""
    res = vote_lr_vs_plain(calls, torch_cuda(device), "a HiFi batch")
    if built:
        res["ptxas"] = ptxas_info(built["vote_lr"][2])
    say("kernel_vote_lr", **res, card=card)
    return res


ONT_READ_LEN, ONT_BATCH, ONT_TIMED = 30_000, 16, 2


def ont_workload(n_reads: int, genome_len: int = GENOME_LEN, read_len: int = ONT_READ_LEN):
    """bench.py's gen_ont_reads recipe (bench.py:383-416) on the bench
    genome, in memory: reads of read_len source bases with 3%
    substitutions, 1% insertions and 1% deletions, half
    reverse-complemented (the first n_reads of bench.py's 100). Returns
    (genome, reads)."""
    from gdiet_tpu_torch.io.fastx import SeqRecord

    g = np.random.default_rng(SEED).integers(0, 4, genome_len, dtype=np.int64)
    rng = np.random.default_rng(SEED + 2)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for n in range(n_reads):
        st = int(rng.integers(0, len(g) - read_len))
        out = []
        for b in g[st: st + read_len]:
            r = rng.random()
            if r < 0.01:  # deletion
                continue
            if r < 0.02:  # insertion
                out.append(int(rng.integers(0, 4)))
            if r < 0.05:  # substitution
                b = (b + int(rng.integers(1, 4))) % 4
            out.append(int(b))
        arr = np.array(out, np.int64)
        if rng.random() < 0.5:
            arr = 3 - arr[::-1]
        s_ = bases[arr].tobytes().decode()
        reads.append(SeqRecord(f"o{n}", s_, "I" * len(s_)))
    return bases[g].tobytes().decode(), reads


def phase_ont(device, n_timed: int, genome_len: int, card: str, B: int = ONT_BATCH,
              read_len: int = ONT_READ_LEN) -> dict:
    """The ONT path at full size, its first run on the card: bench.py's
    ont_stats options and mapper budgets (max_read_len 32,768, seed budget
    4,096, hit budget 8,192, vote budget 4,096, band 1300, K = 3) on
    ont_workload's 30 kb reads, batches of B, 1 warm-up + n_timed timed
    through map_stream. Checks: >= 90% of reads mapped; the DP, backtrack
    and vote_lr kernels launched and no plain version called (the LR vote
    loops and ``_stream_columns`` included) in the timed window; one
    batch's captured vote stream (M = 8,194) through vote_lr.cu and the
    plain loops, exact. Reports reads/s, fallbacks and host DP segments
    (``LongReadMapper.stats``) and one batch's per-phase times."""
    import torch

    from gdiet_tpu_torch import config
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.pipeline.longread import LongReadMapper

    cuda = torch_cuda(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    genome, reads = ont_workload(B * (n_timed + 1), genome_len, read_len)
    gen_s = time.perf_counter() - t0
    io_, mo = config.options_for(
        "map-ont", variant="lr", pattern="10", k=15, w=10, max_seeds=0.2, bw=1300,
        vt_dis=1000, vt_nb_loc=3, vt_df1=0.007, vt_df2=0.007, max_min_gap=4000, vt_f=0.04,
        min_dp_max=35000, vt_cov=0.3, best_n=1)
    t0 = time.perf_counter()
    mi = build_index([("chr1", genome)], io_, device)
    sync()
    index_s = time.perf_counter() - t0
    mapper = LongReadMapper(mi, mo, max_read_len=32768, seed_budget=4096,
                            shift_seed_budget=1024, hit_budget=8192, vote_budget=4096,
                            device=device)
    batches = [reads[i * B:(i + 1) * B] for i in range(n_timed + 1)]
    t0 = time.perf_counter()
    results = list(mapper.map_stream(iter(batches[:1])))  # warm-up batch
    sync()
    warm_s = time.perf_counter() - t0
    warm = dict(mapper.stats)
    lr_counts_reset()
    t0 = time.perf_counter()
    results += list(mapper.map_stream(iter(batches[1:])))
    sync()
    wall = time.perf_counter() - t0
    counts = lr_counts("the ONT path", cuda)
    regs = [r for batch in results for r in batch]
    n_mapped = sum(bool(r) for r in regs)
    check(n_mapped >= 0.9 * len(reads), f"only {n_mapped}/{len(reads)} ONT reads mapped")
    phases, seen = lr_batch_phases(mapper, batches[1], sync)
    calls = capture_lr_votes(mapper, batches[1])
    vote_run = vote_lr_vs_plain(calls, cuda, "an ONT batch")
    res = {"reads": len(reads), "timed_reads": B * n_timed, "batch": B,
           "read_len_source": read_len, "mean_read_len": float(np.mean([r.l_seq for r in reads])),
           "reads_per_s": B * n_timed / wall, "timed_wall_s": wall, "warm_up_s": warm_s,
           "workload_s": gen_s, "index_build_s": index_s,
           "fallback_reads": mapper.stats["fallback_reads"] - warm["fallback_reads"],
           "warm_up_fallback_reads": warm["fallback_reads"],
           "host_dp_segments": mapper.stats["host_dp_segments"] - warm["host_dp_segments"],
           "mapped_reads": n_mapped, **counts, "phase_ms": phases,
           "dp_calls_in_batch": len(seen), "vote": vote_run, "card": card}
    say("ont", **res)
    res["dp_calls"] = seen  # for kernel_int16
    res["vote_calls"] = calls  # for prev_vote_lr
    return res


LR_CELL_READS, LR_CELL_GENOME_MBP = 24, 20


def lr_cell_workload(n_reads: int, genome_mbp: float, mix: dict | None = None):
    """Reads of the benchmark cell pacbio_hifi.wgs's model (its traffic
    file's lengths, 5-30 kb, and errors; ``mix`` replaces the file) on a
    genome of its generator at ``genome_mbp``. Returns (refs, reads)."""
    import json as json_

    from benchmark import genome, traffic
    from gdiet_tpu_torch.io.fastx import SeqRecord

    if mix is None:
        mix = json_.loads((ROOT / "benchmark" / "traffic" / "hifi_wgs.json").read_text())
    seqs = genome.make_genome({"genome_mbp": genome_mbp}, SEED)
    tr = traffic.Traffic(mix, seqs, SEED)
    reads = [SeqRecord(f"c{n}", s_, "I" * len(s_))
             for n, s_ in enumerate(traffic.seq(r) for r in tr.reads(n_reads, 7))]
    return [(name, traffic.seq(c)) for name, c in seqs], reads


def phase_lr_cell(device, card: str, n_reads: int = LR_CELL_READS,
                  genome_mbp: float = LR_CELL_GENOME_MBP, mix: dict | None = None) -> dict:
    """One batch of the benchmark cell's HiFi model under its command line
    (band 1000, ``-s 400``) through a LongReadMapper at its defaults
    (envelope 32,768, default budgets): the kernel launch counts reset
    just before and checked just after (``lr_counts``), every read
    through the front with no fallback and no host DP segment, every
    read's SAM equal to the scalar oracle's, and the first DP call of each
    windowed bucket shape the batch made (the (16384, 17408) and (32768,
    34048) buckets among them) through the band and backtrack kernels
    against their plain versions (``lr_dp_call_check``), exact."""
    import torch

    from gdiet_tpu_torch import config
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.oracle import longread as olr
    from gdiet_tpu_torch.pipeline.longread import LongReadMapper

    cuda = torch_cuda(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    refs, reads = lr_cell_workload(n_reads, genome_mbp, mix)
    io_, mo = config.options_for(
        "map-hifi", variant="lr", pattern="10", k=19, w=19, max_seeds=0.2, bw=1000,
        vt_dis=650, vt_nb_loc=5, vt_df1=0.0106, vt_df2=0.2, min_dp_max=400,
        vt_cov=0.04, vt_f=0.04)
    mo.flag |= config.MM_F_OUT_SAM | config.MM_F_CIGAR  # -a
    mi = build_index(refs, io_, device)
    mapper = LongReadMapper(mi, mo, n_threads=3, device=device)
    mapper.map_batch(reads[:2])  # warm-up
    warm = dict(mapper.stats)
    lr_counts_reset()
    phases, seen = lr_batch_phases(mapper, reads, sync)
    counts = lr_counts("the cell's HiFi batch", cuda)
    st = {k_: v - warm[k_] for k_, v in mapper.stats.items()}
    check(st["front_reads"] == len(reads) and st["fallback_reads"] == 0
          and st["host_dp_segments"] == 0,
          f"the cell's HiFi batch did not map whole on the device path: {st}")
    regs = mapper.map_batch(reads)
    mine = [mapper.regs_to_sam_lines(r, x) for r, x in zip(reads, regs)]
    oracle = mapper._map_parallel(lambda r: mapper.regs_to_sam_lines(r, olr.map_read_lr(
        mapper.mi.oracle_view(), r.seq, mo, mapper.mid_occ, r.name)), reads)
    check(mine == oracle, "the cell's HiFi batch's SAM differs from the scalar oracle's")
    shapes, runs = set(), []
    for call in windowed_calls(seen):
        shape = (call[0][5], call[1]["Lt"])
        if shape not in shapes:
            shapes.add(shape)
            t0 = time.perf_counter()
            runs.append({**lr_dp_call_check(call, f"the cell's HiFi batch's {shape} call"),
                         "check_s": time.perf_counter() - t0})
    res = {"reads": len(reads), "bases": sum(r.l_seq for r in reads),
           "longest_read": max(r.l_seq for r in reads), "genome_mbp": genome_mbp,
           **counts, "stats": st, "phase_ms": phases, "dp_calls_in_batch": len(seen),
           "dp_shapes": sorted({(a[5], kw["Lt"]) for a, kw in seen}),
           "oracle_reads_equal": len(reads), "runs": runs,
           "max_abs_err": max([r["max_abs_err"] for r in runs], default=0),
           "backtrack_max_abs_err": max([r["backtrack_max_abs_err"] for r in runs],
                                        default=0), "card": card}
    say("lr_cell", **res)
    check(any(r["Lmax"] >= 16384 for r in runs),
          f"the cell's HiFi batch made no windowed DP call at 16,384 or more: {res['dp_shapes']}")
    return res


# the int16 kernels of each layout, their launch counts' names in ops/extd2.py
INT16_KERNELS = {"full": ("extd2_i16", "i16_launches"),
                 "band": ("extd2_band_i16", "band_i16_launches"),
                 "fold": ("extd2_fold_i16", "fold_i16_launches")}


def dp16x2_ops(sass: dict) -> int:
    """The 16x2 DPX instructions of a SASS histogram (sass_vi_ops): the VI*
    opcodes with a U16 or S16 modifier (VIMNMX.U16x2, VIMNMX3.U16x2,
    VIADDMNMX.S16x2)."""
    return sum(v for k, v in sass["vi_opcodes"].items()
               if {"U16", "S16"} & set(k.split(".")[1:]))


def int16_run(call, what: str, plain: bool, reps: int | None = None) -> dict:
    """One captured DP call through the int16 kernel of its layout and the
    int32 kernel: outputs exact; with ``plain`` also against the plain int16
    version (one run, timed). Times in turns (int32, int16, int16, int32),
    each the median of KERNEL_ROUNDS rounds of ``reps`` launches; the bound
    counts a packed 16x2 operation as two lane operations. A windowed call
    also reports how ``extd2_band_i16.cu`` runs it (``band_i16_report``)."""
    import torch

    from gdiet_tpu_torch.ops import dp, dp_band, dp_fold, extd2

    (q, t, ln, bd, params, L), kw = call
    route = kw.get("state_dtype", "int32")
    kw = {k: v for k, v in kw.items() if k != "state_dtype"}
    Lt = kw.get("Lt") or L
    tl = kw.get("tlens")
    windowed = kw.get("band_budget") is not None and dp_band.window_geometry(
        kw["band_budget"], dp.round_up(Lt, 128), kw.get("unroll", dp_band.DP_UNROLL)) is not None
    layout = "band" if windowed else "fold" if kw.get("fold") else "full"
    name, count = INT16_KERNELS[layout]
    counter = getattr(extd2, count)

    def k32():
        return extd2.extd2_batch(q, t, ln, bd, params, L, **kw)

    def k16():
        return extd2.extd2_batch(q, t, ln, bd, params, L, **kw, state_dtype="int16")

    T = dp.round16(Lt)
    want = (len(extd2.i16_full_plan(int(q.shape[0]), T, torch.cuda.get_device_properties(
        q.device).multi_processor_count)) if layout == "full" and T <= extd2.I16_WARP_LANES
        else 1)
    n0 = counter.n
    got = k16()
    check(counter.n == n0 + want,
          f"{what}: extd2_batch(state_dtype='int16') made {counter.n - n0} launches of {name}, "
          f"not {want}")
    ref32 = k32()
    err32 = check_equal(got, ref32, DP_OUTPUTS, f"{name} against the int32 kernel on {what}")
    res = {"kernel": name, "route_state": route, "rows": int(q.shape[0]),
           "live_rows": int((ln > 0).sum()), "Lmax": L, "Lt": Lt,
           "band_budget": kw.get("band_budget"),
           "max_abs_err_vs_int32": err32}
    if plain:
        t0 = time.perf_counter()
        if layout == "band":
            ref = dp_band.extd2_band(q, t, ln, bd, params, L, tl, Lt, kw["band_budget"],
                                     kw["unroll"], "int16")
        elif layout == "fold":
            ref = dp_fold.extd2_fold(q, t, ln, bd, params, L, tl, kw.get("Lt"), "int16")
        else:
            ref = dp.extd2_batch(q, t, ln, bd, params, L, tl, kw.get("Lt"), "int16")
        torch.cuda.synchronize()
        res.update(max_abs_err=check_equal(got, ref, DP_OUTPUTS, f"{name} on {what}"),
                   plain_ms=(time.perf_counter() - t0) * 1e3)
    else:
        ref = None
    if layout == "band":
        res["band_i16"] = band_i16_report(call, what, ref32, ref, reps)
    if layout == "full":
        res["full_i16"] = full_i16_report(call)
    del ref, ref32
    for _ in range(2):
        k32()
        k16()
    ms = [rounds_ms(k32, reps), rounds_ms(k16, reps), rounds_ms(k16, reps), rounds_ms(k32, reps)]
    res.update(int16_ms=float(np.mean(ms[1:3])), int32_ms=float(np.mean([ms[0], ms[3]])),
               turns_ms=ms)
    res["int16_over_int32"] = res["int16_ms"] / res["int32_ms"]
    if layout == "band":
        res["band_i16"]["us_per_live_wavefront"] = (res["int16_ms"] * 1e3
                                                    / max(res["band_i16"]["live_wavefronts"], 1))
    if layout == "full":
        f = res["full_i16"]
        f["us_per_live_wavefront"] = res["int16_ms"] * 1e3 / max(f["live_wavefronts"], 1)
        f["ns_per_row_wavefront"] = res["int16_ms"] * 1e6 / max(f["row_wavefronts"], 1)
    b = dp_bound((q, t, ln, bd, tl), got, L, Lt)
    res.update(bound(b["bytes"], b["int_ops"] / 2), cells=b["cells"])
    res["share_of_bound"] = res["bound_ms"] / res["int16_ms"]
    return res


def full_i16_report(call) -> dict:
    """How ``extd2_i16.cu`` runs one full-width call: its warp-route plan
    (``extd2.i16_plan``: per launch the layout, rows a DP warp, zero warps,
    resident blocks an SM, registers, local bytes; the block route above
    512 lanes has none), live rows, the longest row's live wavefronts and
    the wavefronts of all live rows (each row to qlen + tlen - 1)."""
    from gdiet_tpu_torch.ops import dp, extd2

    (q, t, ln, bd, params, L), kw = call
    Lt = kw.get("Lt") or L
    tl = kw.get("tlens")
    lens = ln.cpu().numpy()
    tlens = lens if tl is None else tl.cpu().numpy()
    T = dp.round16(Lt)
    ends = np.where((lens > 0) & (tlens > 0),
                    np.minimum(L + Lt - 1, lens.astype(np.int64) + tlens - 1), 0)
    return {"plan": extd2.i16_plan(int(q.shape[0]), T, L, q.device) if T <= 512 else None,
            "live_rows": int((ends > 0).sum()), "live_wavefronts": live_steps(lens, tlens),
            "row_wavefronts": int(ends.sum())}


def band_i16_report(call, what: str, ref32, ref, reps: int | None) -> dict:
    """How ``extd2_band_i16.cu`` runs one windowed call: the cluster size
    the rule picks (``extd2.band_i16_plan``), the clusters of that size the
    card holds at once, live rows, warps a block and the longest
    candidate's live wavefronts; then the kernel at every cluster size it
    takes (``extd2.band_cluster_sizes``), each exact against the int32
    kernel's outputs (``ref32``) and the plain int16 version's (``ref``,
    where this call ran it), timed in turns (the sizes up, then down; each
    the median of KERNEL_ROUNDS rounds of ``reps`` launches) with us per
    live wavefront."""
    from gdiet_tpu_torch.ops import dp_band, extd2

    (q, t, ln, bd, params, L), kw = call
    Lt, bb, U = kw["Lt"], kw["band_budget"], kw["unroll"]
    tl = kw.get("tlens")
    tl = ln if tl is None else tl
    N = int(q.shape[0])
    WB = dp_band.band_shape(L, Lt, bb, U)[2]
    plan = extd2.band_i16_plan(N, L, WB, q.device)
    steps = live_steps(ln.cpu().numpy(), tl.cpu().numpy())
    sizes = extd2.band_cluster_sizes(WB)
    fns, errs = {}, {}
    for C in sizes:
        def fn(C=C):
            return extd2._extd2_band_cuda(q, t, ln, bd, params, L, tl, Lt, bb, U, "int16",
                                          cluster=C)
        got = fn()
        errs[C] = max([check_equal(got, ref32, DP_OUTPUTS,
                                   f"extd2_band_i16 at C = {C} against int32 on {what}")]
                      + ([check_equal(got, ref, DP_OUTPUTS,
                                      f"extd2_band_i16 at C = {C} against plain on {what}")]
                         if ref is not None else []))
        del got
        fns[C] = fn
    turns = {C: [] for C in sizes}
    for C in sizes + sizes[::-1]:
        turns[C].append(rounds_ms(fns[C], reps))
    return {**plan, "live_rows": int((ln > 0).sum()), "live_wavefronts": steps,
            "clusters": {str(C): {"ms": float(np.mean(turns[C])), "turns_ms": turns[C],
                                  "us_per_live_wavefront": float(np.mean(turns[C])) * 1e3
                                  / max(steps, 1),
                                  "max_abs_err": errs[C],
                                  "held_against_plain": ref is not None}
                         for C in sizes}}


def phase_prev_band(lib, card: str, calls: dict) -> dict:
    """``--prev DIR`` with an earlier ``extd2_band_i16.cu`` (one block a
    candidate, ``build_prev``): on each windowed DP call of the HiFi batch
    and the ONT batch (``calls``) the earlier source and the checkout's
    (through ``extd2_batch``, at the cluster size the rule picks) give the
    same score and dirs (exact) and are timed in turns (earlier, current,
    current, earlier; each the median of KERNEL_ROUNDS rounds). The
    checkout's must not be slower beyond 1%."""
    import torch

    from gdiet_tpu_torch.ops import dp, dp_band, extd2

    runs = []
    for path, cs in calls.items():
        for i, ((q, t, ln, bd, params, L), kw) in enumerate(cs):
            Lt, bb, U = kw.get("Lt") or L, kw.get("band_budget"), kw.get("unroll")
            if (kw.get("state_dtype") != "int16" or bb is None
                    or dp_band.window_geometry(bb, dp.round_up(Lt, 128), U) is None):
                continue
            tl = kw.get("tlens")
            tl = ln if tl is None else tl
            N = int(q.shape[0])
            T, R, WB = dp_band.band_shape(L, Lt, bb, U)

            def old():
                score = torch.empty((N,), dtype=torch.int32, device=q.device)
                dirs = torch.empty((N, R, WB), dtype=torch.uint8, device=q.device)
                rc = lib.gdiet_extd2_band_i16(
                    q.data_ptr(), t.data_ptr(), ln.data_ptr(), tl.data_ptr(), bd.data_ptr(),
                    score.data_ptr(), dirs.data_ptr(), N, L, Lt, T, R, WB, bb, U,
                    *dp.derive_scoring(params), torch.cuda.current_stream().cuda_stream)
                check(rc == 0, f"the earlier extd2_band_i16 failed: CUDA error {rc}")
                return score, dirs

            def new():
                return extd2.extd2_batch(q, t, ln, bd, params, L, **kw)

            a, b = old(), new()
            err = check_equal(a, b, DP_OUTPUTS,
                              f"earlier and current extd2_band_i16 on the {path} call {i}")
            del a, b
            reps = 2 if L > 8192 else None
            times = [rounds_ms(f, reps) for f in (old, new, new, old)]
            old_ms, new_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            runs.append({"path": path, "call": i, "rows": N, "live_rows": int((ln > 0).sum()),
                         "Lmax": L, "Lt": Lt, "band_budget": bb,
                         "cluster": extd2.band_i16_plan(N, L, WB, q.device)["cluster"],
                         "earlier_ms": old_ms, "current_ms": new_ms,
                         "speedup": old_ms / new_ms, "turns_ms": times, "max_abs_err": err})
    check(bool(runs), "no windowed int16 DP call to time against the earlier source")
    out = {"runs": runs, "card": card}
    say("prev_band", **out)
    for r in runs:
        check(r["current_ms"] <= 1.01 * r["earlier_ms"],
              f"extd2_band_i16 slower than the earlier source on the {r['path']} call "
              f"{r['call']}: {r['current_ms']:.3f} against {r['earlier_ms']:.3f} ms")
    return out


def phase_prev_vote_lr(lib, card: str, calls: dict) -> dict:
    """``--prev DIR`` with an earlier ``vote_lr.cu`` (same C entry points,
    e.g. one thread a read over ``vote_tile.cuh``'s tiles, which DIR then
    holds beside it): on the vote calls of the HiFi and ONT batches
    (``calls``: {path: capture_lr_votes' calls}) both entry points of the
    earlier source and the checkout's, each alone on preallocated outputs:
    outputs equal (exact), timed in turns (earlier, current, current,
    earlier) by device time (torch.profiler) and CUDA events (median of
    KERNEL_ROUNDS rounds; the host's enqueue bounds these at this size).
    The checkout's device time must not be longer beyond 1%."""
    import torch

    from gdiet_tpu_torch.ops import extd2, vote

    cur = extd2._library("vote_lr")
    runs = []
    for path, c in calls.items():
        (a1, _), = c["vote_lr"]
        (a2, _), = c["vote2_pair"]
        halves, (ex, dist, cov, K) = a1[:6], a1[6:10]
        wins = a2[8:12]
        B, A, ld, ptrs = vote._halves(*halves)
        dev = halves[0].device

        def entries(lib_):
            o1 = {n: torch.empty((B,) if n == "out_len" else (B, K),
                                 dtype=torch.int64 if n.endswith("_t") else torch.int32,
                                 device=dev) for n in vote.LR_OUTPUTS}
            o2 = torch.empty((B, 16), dtype=torch.int32, device=dev)

            def r1():
                rc = lib_.gdiet_vote_lr(*ptrs, ld, ex.data_ptr(), dist.data_ptr(), cov.data_ptr(),
                                        *(o1[n].data_ptr() for n in vote.LR_OUTPUTS), B, A, K,
                                        extd2._stream(dev))
                check(rc == 0, f"vote_lr failed: CUDA error {rc}")
                return o1

            def r2():
                rc = lib_.gdiet_vote2_pair(*ptrs, ld, ex.data_ptr(), dist.data_ptr(),
                                           *(w.data_ptr() for w in wins), o2.data_ptr(), B, A,
                                           extd2._stream(dev))
                check(rc == 0, f"vote2_pair failed: CUDA error {rc}")
                return o2
            return r1, r2

        (old1, old2), (new1, new2) = entries(lib), entries(cur)
        err = max(check_equal([old1()[n] for n in vote.LR_OUTPUTS],
                              [new1()[n] for n in vote.LR_OUTPUTS], vote.LR_OUTPUTS,
                              f"earlier and current vote_lr on the {path} batch"),
                  check_equal([old2()], [new2()], ("vote2",),
                              f"earlier and current vote2_pair on the {path} batch"))
        for entry, old, new, kern in (("vote_lr", old1, new1, "vote_lr"),
                                      ("vote2_pair", old2, new2, "vote2_pair")):
            dev_ms = [device_ms(f, kern) for f in (old, new, new, old)]
            ev_ms = [rounds_ms(f) for f in (old, new, new, old)]
            r = {"path": path, "entry": entry, "B": B, "M": 2 * (A + 1), "K": K,
                 "events_turns_ms": ev_ms, "max_abs_err": err}
            if None not in dev_ms:
                o, n = (dev_ms[0] + dev_ms[3]) / 2, (dev_ms[1] + dev_ms[2]) / 2
                r.update(earlier_device_ms=o, current_device_ms=n, device_speedup=o / n,
                         device_turns_ms=dev_ms)
            runs.append(r)
    out = {"runs": runs, "card": card}
    say("prev_vote_lr", **out)
    for r in runs:
        if "current_device_ms" in r:
            check(r["current_device_ms"] <= 1.01 * r["earlier_device_ms"],
                  f"{r['entry']} slower than the earlier source on the {r['path']} batch: "
                  f"{r['current_device_ms']:.4f} against {r['earlier_device_ms']:.4f} ms")
    return out


def se_fold_call() -> tuple:
    """The SE step's DP call as the fold takes it (phase kernel_fold's
    seeded 6,272 rows at 160 lanes), on its route's lane state."""
    import torch

    from gdiet_tpu_torch.ops.extd2 import route_state_dtype

    L = KERNEL_SHAPE["L"]
    args = tuple(torch.from_numpy(a).cuda() for a in dp_pairs(KERNEL_SHAPE["N"], L,
                                                                 KERNEL_SHAPE["qlen"]))
    return args + (PARAMS, L), {"fold": True, "state_dtype": route_state_dtype(PARAMS, L,
                                                                               fold=True)}


def phase_prev_fold_i16(lib, card: str, calls: dict) -> dict:
    """``--prev DIR`` with an earlier ``extd2_fold_i16.cu`` (same C entry
    point, e.g. one in which every thread computes the row scalars and
    walks H0; ``dp_pair.cuh`` beside it in DIR): on the PE step's captured
    fold call and the SE fold call (``calls``) the earlier source, the
    checkout's and ``extd2_fold.cu`` (int32), all through ``extd2_batch``:
    score and dirs exact, timed in turns (int32, earlier, current, current,
    earlier, int32; each the median of KERNEL_ROUNDS rounds). The
    checkout's must not be slower than the earlier source beyond 1%."""
    from gdiet_tpu_torch.ops import extd2

    cur = extd2._library("extd2_fold_i16")
    runs = []
    for path, ((q, t, ln, bd, params, L), kw) in calls.items():
        kw = {k: v for k, v in kw.items() if k != "state_dtype"}

        def new():
            return extd2.extd2_batch(q, t, ln, bd, params, L, **kw, state_dtype="int16")

        def old():
            extd2._libs["extd2_fold_i16"] = lib
            try:
                return new()
            finally:
                extd2._libs["extd2_fold_i16"] = cur

        def k32():
            return extd2.extd2_batch(q, t, ln, bd, params, L, **kw)

        a, b, c = old(), new(), k32()
        err = max(check_equal(a, b, DP_OUTPUTS, f"earlier and current extd2_fold_i16 on {path}"),
                  check_equal(b, c, DP_OUTPUTS, f"extd2_fold_i16 against int32 on {path}"))
        del a, b, c
        ms = [rounds_ms(f) for f in (k32, old, new, new, old, k32)]
        o, n, i32 = (ms[1] + ms[4]) / 2, (ms[2] + ms[3]) / 2, (ms[0] + ms[5]) / 2
        runs.append({"path": path, "rows": int(q.shape[0]), "live_rows": int((ln > 0).sum()),
                     "Lmax": L, "earlier_ms": o, "current_ms": n, "int32_ms": i32,
                     "speedup": o / n, "current_over_int32": n / i32, "turns_ms": ms,
                     "max_abs_err": err})
    out = {"runs": runs, "card": card}
    say("prev_fold_i16", **out)
    for r in runs:
        check(r["current_ms"] <= 1.01 * r["earlier_ms"],
              f"extd2_fold_i16 slower than the earlier source on {r['path']}: "
              f"{r['current_ms']:.3f} against {r['earlier_ms']:.3f} ms")
    return out


def int16_err(report: dict, kernel: str) -> int:
    """The largest difference of ``kernel`` against its plain version and
    the int32 kernel over phase kernel_int16's runs (0)."""
    return max(max(r.get("max_abs_err", 0), r["max_abs_err_vs_int32"])
               for runs in report["runs"].values() for r in runs if r["kernel"] == kernel)


def seeded_full_calls() -> dict:
    """The full-width calls the paths' captured calls do not cover, on
    seeded rows: the route's other short-read widths, 112 (100 bp reads),
    128 and 192 lanes, at the SE batch's size; and the LR route's
    full-width bucket (512, 1024) at map-hifi's default band 1000, where
    the window does not engage (extd2_i16.cu's block route), on seeded
    windows as phase kernel_band runs it."""
    import torch

    from gdiet_tpu_torch.ops import dp_band
    from gdiet_tpu_torch.ops.extd2 import route_state_dtype

    widths = []
    for L in (112, 128, 192):
        Q, T, lens, band = dp_pairs(KERNEL_SHAPE["N"], L, L - 10 if L > 112 else 100)
        widths.append((tuple(torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
                       + (PARAMS, L), {"fold": False, "state_dtype": route_state_dtype(PARAMS, L)}))
    Q, T, lens, tlens = band_windows(64, 512, 1024, seed=5)
    args = tuple(torch.from_numpy(a).cuda() for a in (Q, T, lens, np.full(64, 1000, np.int32)))
    lr = (args + (LR_PARAMS, 512),
          {"tlens": torch.from_numpy(tlens).cuda(), "Lt": 1024, "band_budget": 1000,
           "unroll": dp_band.LR_UNROLL,
           "state_dtype": route_state_dtype(LR_PARAMS, 512, 1024, band_budget=1000,
                                            unroll=dp_band.LR_UNROLL)})
    return {"widths": widths, "lr_full_width": [lr]}


def phase_prev_full(lib, card: str, calls: dict) -> dict:
    """``--prev DIR`` with an earlier ``extd2_i16.cu`` (one C entry point,
    ``gdiet_extd2_i16``, for every width; ``build_prev``): on each
    full-width call (``calls``: the SE step's at 160 lanes, the generic
    step's at 256 and 512 lanes, the seeded rows at 112, 128 and 192 lanes
    and the LR (512, 1024) bucket's seeded windows, the block route) the
    earlier source and the checkout's (``extd2.launch_full_i16``: its
    plan's launches), each on preallocated outputs, give the same score
    and dirs (exact) and are timed in turns (earlier, current, current,
    earlier; each the median of KERNEL_ROUNDS rounds). The checkout's must
    not be slower beyond 1%."""
    import torch

    from gdiet_tpu_torch.ops import dp, extd2

    cur = extd2._library("extd2_i16")
    runs = []
    for path, cs in calls.items():
        for i, ((q, t, ln, bd, params, L), kw) in enumerate(cs):
            Lt = kw.get("Lt") or L
            tl = kw.get("tlens")
            N, T, R = int(q.shape[0]), dp.round16(Lt), L + Lt - 1
            outs = [(torch.empty((N,), dtype=torch.int32, device=q.device),
                     torch.empty((N, R, T), dtype=torch.uint8, device=q.device))
                    for _ in range(2)]

            def alone(lib_, out):
                score, dirs = out
                args = (q.data_ptr(), t.data_ptr(), ln.data_ptr(),
                        tl.data_ptr() if tl is not None else None, bd.data_ptr(),
                        score.data_ptr(), dirs.data_ptr(), N, L, Lt, T, R,
                        *dp.derive_scoring(params))

                def run():
                    if lib_ is cur:
                        extd2.launch_full_i16(cur, q.device, *args)
                        return
                    rc = lib_.gdiet_extd2_i16(*args, torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, f"the earlier extd2_i16 failed: CUDA error {rc}")
                return run

            old, new = alone(lib, outs[0]), alone(cur, outs[1])
            old()
            new()
            err = check_equal(outs[0], outs[1], DP_OUTPUTS,
                              f"earlier and current extd2_i16 on the {path} call {i}")
            kt = [rounds_ms(f) for f in (old, new, new, old)]
            old_ms, new_ms = (kt[0] + kt[3]) / 2, (kt[1] + kt[2]) / 2
            runs.append({"path": path, "call": i, "rows": N, "live_rows": int((ln > 0).sum()),
                         "Lmax": L, "Lt": Lt, "earlier_ms": old_ms, "current_ms": new_ms,
                         "speedup": old_ms / new_ms, "turns_ms": kt, "max_abs_err": err})
            del outs
    check(bool(runs), "no full-width call to time against the earlier source")
    out = {"runs": runs, "card": card}
    say("prev_full", **out)
    for r in runs:
        check(r["current_ms"] <= 1.01 * r["earlier_ms"],
              f"extd2_i16 slower than the earlier source on the {r['path']} call "
              f"{r['call']}: {r['current_ms']:.3f} against {r['earlier_ms']:.3f} ms")
    return out


def fold_i16_launch(registers: int, L: int = 160) -> dict:
    """extd2_fold_i16.cu's launch at the SE/PE width (Lmax = Lt = L): a
    block of T / 2 compute threads and the filler and walker warps, its
    dynamic shared memory (the row and tap rings, the pass shift's words,
    the warps' last pairs, the queries and the target), resident blocks an
    SM, and the two helper warps' share of the block's warps."""
    from gdiet_tpu_torch.ops import dp_fold

    _, T, _ = dp_fold.fold_geometry(L)
    NP, W = T // 2, T // 64
    shm = 2 * 4 * 48 + 2 * NP * 8 + (8 * NP + 2 * W * 3) * 4 + 2 * L + T
    return {"lanes": T, "threads": NP + 64, "shared_bytes": shm,
            **blocks_per_sm(registers, shm, NP + 64), "helper_warp_share": 2 / (W + 2)}


def phase_kernel_int16(card: str, calls: dict, built=None, seeded=None) -> dict:
    """Each int16 kernel against the int32 kernel of its layout and its
    plain int16 version on the DP calls the paths made (``calls``: {path:
    [(args, kwargs), ...]} as the main, generic, pe, lr and ont phases
    captured them): the SE step's full width (160 lanes; extd2_i16.cu's
    two-rows-a-warp layout), the generic step's at 256 and 512
    lanes (the plain version on the 512-lane call, 8,192 rows), the PE
    step's fold (5,120 rows; extd2_fold_i16.cu), each DP call of one HiFi
    batch (extd2_band_i16.cu; the full-width (512, 1024) bucket, where the
    batch has one, extd2_i16.cu's block route) and the ONT batch's (32768,
    34048) chunk. All outputs exact, against the plain version once per
    HiFi and ONT bucket shape (the ONT chunk's plain run takes minutes).
    Times in turns against int32, bounds (a packed 16x2 operation counts
    as two lane operations), shares; with ``built`` ptxas registers and
    spills and the 16x2 DPX instructions of each kernel's SASS (> 0).
    Where a path's route takes int16 (the lane state of its captured
    call), the int16 kernel must not be slower there than int32 beyond the
    spread of the int32 rounds (1%); the ratio of the int32-routed calls is
    reported. The route's other short-read widths, 112, 128 and 192 lanes,
    and the LR route's full-width (512, 1024) bucket are timed on seeded
    rows (``seeded_full_calls``, or ``seeded``). Each full-width call also
    reports the warp route's plan, registers, local bytes and resident
    blocks an SM (``full_i16_report``), us per live wavefront (the longest
    row's) and ns per row wavefront (all live rows')."""
    from gdiet_tpu_torch.ops import dp_band

    t_phase = time.perf_counter()

    def first_of_shape(cs):
        """Whether each call is the first of its (Lmax, Lt) shape."""
        seen = set()
        for (a, kw) in cs:
            shape = (a[5], kw.get("Lt"))
            yield shape not in seen
            seen.add(shape)

    runs = {"se": [int16_run(calls["se"][0], "the SE step's DP call", True)],
            "generic": [int16_run(c, f"the generic step's DP call at Lmax {c[0][5]}",
                                  c[0][5] == 512)
                        for c in calls["generic"]],
            "pe": [int16_run(calls["pe"][0], "the PE step's DP call", True)],
            "se_fold": [int16_run(calls["se_fold"][0], "the SE fold call (6,272 seeded rows)",
                                  False)]}
    hifi = calls["hifi"]
    check(any(c[1].get("band_budget") is not None
              and dp_band.band_shape(c[0][5], c[1]["Lt"], c[1]["band_budget"],
                                     c[1]["unroll"])[2] is not None for c in hifi),
          "the HiFi batch made no windowed DP call")
    runs["hifi"] = [int16_run(c, f"the HiFi batch's DP call {i}", plain)
                    for i, (c, plain) in enumerate(zip(hifi, first_of_shape(hifi)))]
    t0 = time.perf_counter()
    runs["ont"] = [int16_run(c, f"the ONT batch's DP call {i}", plain, reps=2)
                   for i, (c, plain) in enumerate(zip(calls["ont"], first_of_shape(calls["ont"])))]
    ont_s = time.perf_counter() - t0
    # the route's other widths and the LR full-width bucket, on seeded rows
    seeded = seeded or seeded_full_calls()
    runs["widths"] = [int16_run(c, f"seeded rows at Lmax {c[0][5]}", False)
                      for c in seeded["widths"]]
    runs["lr_full_width"] = [int16_run(seeded["lr_full_width"][0],
                                       "seeded windows at the (512, 1024) bucket", True)]
    out = {"runs": runs, "ont_seconds": ont_s, "seconds": time.perf_counter() - t_phase}
    routed = {}
    for path, rs in runs.items():
        out[f"{path}_int16_over_int32"] = (sum(r["int16_ms"] for r in rs)
                                           / sum(r["int32_ms"] for r in rs))
        on_route = [r for r in rs if r["route_state"] == "int16"]
        if on_route:
            routed[path] = (sum(r["int16_ms"] for r in on_route)
                            / sum(r["int32_ms"] for r in on_route))
    if built:
        for name, _ in INT16_KERNELS.values():
            sass = sass_vi_ops(built[name][0])
            out[name] = {"ptxas": ptxas_info(built[name][2]), "sass": sass,
                         "dpx_16x2": dp16x2_ops(sass)}
        fold_ptxas = list(out["extd2_fold_i16"]["ptxas"].values())
        if fold_ptxas:  # a build taken from _build/ has no ptxas log
            out["extd2_fold_i16"]["launch"] = fold_i16_launch(fold_ptxas[0]["registers"])
    out["card"] = card
    say("kernel_int16", **out)
    for path, ratio in routed.items():
        check(ratio < 1.01, f"the {path} path routes its DP to int16, but int16 / int32 "
              f"= {ratio:.3f} on those calls")
    for name, _ in INT16_KERNELS.values():
        check(not built or out[name]["dpx_16x2"] > 0, f"no 16x2 DPX instruction in {name}'s SASS")
    return out


# ---------------------------------------------------------------------------
# multi-device mapping (parallel/dist.py) and the -v 4 profile
# ---------------------------------------------------------------------------
MESH_SHAPES = ((2, 2), (1, 4), (4, 1))  # (data, ref)


def compare_meshed(single: tuple, meshed: tuple, K: int, what: str) -> int:
    """A meshed step's (meta, ops) against the single-device step's on the
    same batch: every meta column but ``opsrow`` exact; ``opsrow``'s kind
    (>= 0 a compacted op row, -1 no CIGAR, -2 all-M) equal, and the op row
    each points to equal byte for byte (the compacted rows are numbered
    per data row under a mesh, so the indices differ). Returns the op rows
    compared."""
    (meta1, ops1), (meta2, ops2) = single, meshed
    col = 3 + 11 * K  # opsrow (device_step.PACK_BK)
    check(meta1.shape == meta2.shape, f"{what}: meta {meta2.shape}, expected {meta1.shape}")
    diff = int((meta1[:, :col] != meta2[:, :col]).sum())
    check(diff == 0, f"{what}: {diff} meta entries differ from the single-device step's")
    r1, r2 = meta1[:, col:].ravel(), meta2[:, col:].ravel()
    check(np.array_equal(np.minimum(r1, 0), np.minimum(r2, 0)),
          f"{what}: the opsrow kinds differ from the single-device step's")
    live = r1 >= 0
    check(np.array_equal(ops1[r1[live]], ops2[r2[live]]),
          f"{what}: op rows differ from the single-device step's")
    return int(live.sum())


def step_ms(fused, codes, lens, n: int = 3) -> float:
    """Median host ms of a step call ending in a sync of the mapper's
    card(s), after one warm-up call."""
    ms = []
    for _ in range(n + 1):
        fused.sync()
        t0 = time.perf_counter()
        fused(codes, lens)
        fused.sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms[1:]))


def phase_mesh(device, B: int, card: str, shapes=MESH_SHAPES, distinct: bool = False,
               genome_len: int = GENOME_LEN) -> dict:
    """The main phase's workload (one batch of B reads, the bench budgets,
    the 2 Mbp genome) through ``ShortReadMapper(mesh=...)`` on each mesh
    shape: a virtual mesh whose cells are all ``device``, or with
    ``distinct`` one card per cell. Per mesh, counts reset just before and
    read just after the meshed path (one step call and ``map_stream_sam``):
    the vote, DP and backtrack kernels launched and no plain version.
    Checks, exact against the single-device mapper on the same batch: meta
    and ops (``compare_meshed``), SAM. Each data row's calls at its shapes,
    exact against the plain versions: the DP and backtrack kernels on its
    DP inputs (``dp_call_check``), vote_scan.cu on its vote stream (the
    row's merged hits, M = 2(64 n_ref + 1)). The step's ms beside the
    single-device step's: on one card this is the sharded path's overhead,
    not scaling."""
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.ops import extd2, vote
    from gdiet_tpu_torch.parallel.dist import make_mesh
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    cuda = torch_cuda(device)
    genome, _, _, reads = bench_workload(B, genome_len)
    io_, mo = sr_options()
    mi = build_index([("chr1", genome)], io_, device)
    single = ShortReadMapper(mi, mo, device=device, **MAIN_BUDGETS)
    codes, lens = single.native.encode_batch([r.seq for r in reads], 160)
    want = single.fused.fetch(single.fused(codes, lens), B)
    sam1 = _map_sam(single, reads)
    single_ms = step_ms(single.fused, codes, lens)
    K = single.fused.cfg.K
    runs = []
    for n_data, n_ref in shapes:
        cells = None if distinct else [device] * (n_data * n_ref)
        mapper = ShortReadMapper(mi, mo, mesh=make_mesh(n_data, n_ref, cells), **MAIN_BUDGETS)
        what = f"the ({n_data}, {n_ref}) mesh"
        # ---- the meshed path: counts reset just before, read just after ----
        sr_counts_reset()
        got = mapper.fused.fetch(mapper.fused(codes, lens), B)
        sam2 = _map_sam(mapper, reads)
        counts = sr_counts(what, cuda)
        rows = compare_meshed(want, got, K, what)
        same = sum(a == b for a, b in zip(sam1, sam2))
        check(sam2 == sam1, f"{what}: {same}/{len(sam1)} SAM records equal the single "
              f"device's ({len(sam2)} produced)")
        # ---- each data row's kernel calls against their plain versions ----
        dp_calls = capture_calls(extd2, ["extd2_batch"],
                                 lambda: mapper.fused(codes, lens))["extd2_batch"]
        check(len(dp_calls) == n_data, f"{what} made {len(dp_calls)} DP calls for {n_data} rows")
        dps = [dp_call_check(c, False, f"{what}'s data row {d}") for d, c in enumerate(dp_calls)]
        del dp_calls
        calls = capture_calls(vote, ["vote_scan"], lambda: mapper.fused(codes, lens))["vote_scan"]
        check(len(calls) == n_data, f"{what} made {len(calls)} vote calls for {n_data} rows")
        M = 2 * (calls[0][0][0].shape[1] + 1)
        check(M == 2 * (64 * n_ref + 1), f"{what}: vote stream M = {M}")
        kvs = [vote_vs_plain(c, K, cuda, f"{what}'s data row {d}") for d, c in enumerate(calls)]
        runs.append({"mesh": [n_data, n_ref], "vote_M": M, **counts,
                     "vote_calls_per_batch": len(calls), "ops_rows_compared": rows,
                     "sam_records": len(sam2), "step_ms": step_ms(mapper.fused, codes, lens),
                     "single_step_ms": single_ms,
                     "dp_rows": [r["step_dp_rows"] for r in dps],
                     "dp_max_abs_err": max(r["step_dp_max_abs_err"] for r in dps),
                     "backtrack_max_abs_err": max(r["step_backtrack_max_abs_err"] for r in dps),
                     "vote_max_abs_err": max(kv["max_abs_err"] for kv in kvs),
                     "vote": {k: kvs[0].get(k) for k in ("B", "M", "K", "kernel_ms", "device_ms",
                                                         "plain_ms", "bound_ms", "bound_by")}})
        del mapper, calls
    res = {"reads": B, "runs": runs, "identical": True,
           "cells": "distinct cards" if distinct else f"every cell on {device}",
           "note": "one card's virtual mesh: step_ms is the sharded path's overhead "
                   "(every shard probed, the merge, the data rows in turn), not scaling"
           if not distinct else "distinct cards", "card": card}
    say("mesh_cards" if distinct else "mesh", **res)
    return res


def phase_mesh_lr(device, card: str, B: int = LR_BATCH, genome_len: int = GENOME_LEN) -> dict:
    """One HiFi batch (the lr phase's recipe and budgets) through a (2, 2)
    virtual mesh of ``device``: the front's packed meta equal to the
    single-device front's, and the SAM of ``map_batch`` equal to the
    single-device run's. Counts reset just before and read just after the
    meshed run: the band (or full-width), backtrack and vote_lr kernels
    launched and no plain version. The meshed batch's kernel calls at
    their shapes, exact against their plain versions: both vote_lr.cu
    entry points on each data row's merged stream (``vote_lr_vs_plain``),
    the band and backtrack kernels on its smallest windowed DP bucket
    (``lr_dp_check``)."""
    import torch

    from gdiet_tpu_torch import config
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.ops import extd2
    from gdiet_tpu_torch.parallel.dist import make_mesh
    from gdiet_tpu_torch.pipeline.longread import LongReadMapper

    cuda = torch_cuda(device)
    genome, reads = lr_workload(B, genome_len)
    io_, mo = config.options_for(
        "map-hifi", variant="lr", pattern="10", k=19, w=19, max_seeds=0.2, bw=500,
        vt_dis=650, vt_nb_loc=5, vt_df1=0.0106, vt_df2=0.2, min_dp_max=200,
        vt_cov=0.04, vt_f=0.04)
    mo.flag |= config.MM_F_OUT_SAM | config.MM_F_CIGAR  # -a
    mi = build_index([("chr1", genome)], io_, device)
    kw = dict(max_read_len=4096, seed_budget=512, shift_seed_budget=128, hit_budget=2048,
              vote_budget=512)
    single = LongReadMapper(mi, mo, device=device, **kw)
    meshed = LongReadMapper(mi, mo, mesh=make_mesh(2, 2, [device] * 4), **kw)
    lens = np.array([r.l_seq for r in reads], np.int64)
    front = [m._dispatch_front(reads, lens)[1].cpu().numpy() for m in (single, meshed)]
    check(np.array_equal(*front), "the (2, 2) LR mesh's front meta differs from the single "
          "device's")

    def sam(mapper, results):
        return [l for rec, rg in zip(reads, results) for l in mapper.regs_to_sam_lines(rec, rg)]

    sam1 = sam(single, single.map_batch(reads))
    # ---- the meshed LR path: counts reset just before, read just after ----
    lr_counts_reset()
    t0 = time.perf_counter()
    results = meshed.map_batch(reads)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = lr_counts("the (2, 2) LR mesh", cuda)
    sam2 = sam(meshed, results)
    same = sum(a == b for a, b in zip(sam1, sam2))
    check(sam2 == sam1, f"the (2, 2) LR mesh: {same}/{len(sam1)} SAM records equal")
    n_mapped = sum(bool(r) for r in results)
    check(n_mapped >= 0.9 * B, f"only {n_mapped}/{B} reads mapped on the LR mesh")

    # ---- the meshed batch's kernel calls against their plain versions ----
    votes = capture_lr_votes(meshed, reads, n_rows=2)
    kvl = [vote_lr_vs_plain({n: [votes[n][d]] for n in votes}, cuda,
                            f"the (2, 2) LR mesh's data row {d}") for d in range(2)]
    del votes
    seen = capture_calls(extd2, ["extd2_batch"], lambda: meshed.map_batch(reads))["extd2_batch"]
    step_dp = lr_dp_check(seen, "the (2, 2) LR mesh's batch")
    del seen
    res = {"reads": B, "mesh": [2, 2], "mapped_reads": n_mapped, "sam_records": len(sam2),
           "identical": True, "batch_ms": wall * 1e3, **counts, "step_dp": step_dp,
           "vote_lr": [{"B": r["B"], "M": r["M"], "K": r["K"],
                        **{x: {k: r[x][k] for k in ("kernel_ms", "plain_ms", "max_abs_err")}
                           for x in ("round1", "round2")}} for r in kvl],
           "vote_lr_max_abs_err": max(r[x]["max_abs_err"] for r in kvl
                                      for x in ("round1", "round2")),
           "note": "one card's virtual mesh: batch_ms is not a scaling figure", "card": card}
    say("mesh_lr", **res)
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


MULTIHOST_WORKER = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke
from gdiet_tpu_torch import cli
chip_smoke.sr_counts_reset()
rc = cli.main(sys.argv[1:])
print("COUNTS " + json.dumps(chip_smoke.sr_counts("a joined process", "cuda" in sys.argv)))
sys.exit(rc)
"""


def phase_multihost(card: str, device: str = "cuda") -> dict:
    """Two processes of the port's CLI joined through ``GDIET_COORDINATOR``
    (gloo, a free local port), both on ``device``: each maps half of
    ``tests/data/reads.fq`` with the launch counts set to 0 just before
    and read just after (on the card: the vote, DP and backtrack kernels
    launched, no plain version). Both exit 0 and log a group of 2; their
    records concatenated equal ``golden.sam``."""
    import os
    import tempfile

    from gdiet_tpu_torch.testing import sam_body

    lines = (DATA / "reads.fq").read_text().splitlines()
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    half = len(recs) // 2
    args = [*PE_ARGS[:-2], "-v", "3"]
    coordinator = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        procs, outs = [], []
        t0 = time.perf_counter()
        try:
            for p, shard in enumerate((recs[:half], recs[half:])):
                fq, out = tmp / f"shard{p}.fq", tmp / f"out{p}.sam"
                fq.write_text("\n".join(l for rec in shard for l in rec) + "\n")
                outs.append(out)
                env = {**os.environ, "GDIET_COORDINATOR": coordinator,
                       "GDIET_NUM_PROCESSES": "2", "GDIET_PROCESS_ID": str(p)}
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", MULTIHOST_WORKER, "--device", device, *args,
                     "-o", str(out), str(DATA / "ref.fa"), str(fq)],
                    cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            outs_errs = [pr.communicate(timeout=600) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        wall = time.perf_counter() - t0
        counts = []
        for p, (pr, (so, err)) in enumerate(zip(procs, outs_errs)):
            check(pr.returncode == 0, f"process {p} of the join failed:\n{err[-3000:]}")
            check(f"joined torch.distributed (gloo) as process {p} of 2" in err,
                  f"process {p} logged no group of 2:\n{err[-3000:]}")
            line = [l for l in so.splitlines() if l.startswith("COUNTS ")]
            check(bool(line), f"process {p} reported no launch counts")
            counts.append(json.loads(line[-1][7:]))
        got = [l for out in outs for l in sam_body(out)]
    gold = sam_body(DATA / "golden.sam")
    same = sum(a == b for a, b in zip(got, gold))
    check(got == gold, f"the joined processes' records: {same}/{len(gold)} equal golden.sam")
    res = {"processes": 2, "world_size": 2, "records": len(got), "identical": True,
           "wall_s": wall, "counts": counts, "device": device, "card": card}
    say("multihost", **res)
    return res


PROFILE_STAGES = ("pattern alignment", "seeding", "voting", "sequence alignment")


def phase_profile(device, B: int, card: str, genome_len: int = GENOME_LEN) -> dict:
    """The SE CLI with ``-v 4`` on the main phase's reads (one batch of B,
    the 2 Mbp genome): stderr has the four five-stage ``[PROFILING]`` rows
    (``staged_times``' re-run estimates), pattern, seeding and sequence
    alignment each > 0 ns and voting >= 0 (the difference of two cuts'
    re-run minimums, within their timing noise), and the SAM equals the
    same run's without ``-v 4``."""
    import contextlib
    import io
    import re
    import tempfile

    from gdiet_tpu_torch import cli
    from gdiet_tpu_torch.testing import sam_body
    from gdiet_tpu_torch.utils.profile import PROFILE

    genome, _, _, reads = bench_workload(B, genome_len)
    args = PE_ARGS[:-2]  # without "-v 1"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        fa, fq = write_fastx(tmp, genome, reads)
        PROFILE.reset()
        err = io.StringIO()
        # the -v 4 path: counts reset just before, read just after
        sr_counts_reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            check(cli.main(["--device", device, *args, "-v", "4", "-o", str(tmp / "v4.sam"),
                            str(fa), str(fq)]) == 0, "the -v 4 CLI run failed")
        wall4 = time.perf_counter() - t0
        counts = sr_counts("the -v 4 run", torch_cuda(device))
        t0 = time.perf_counter()
        check(cli.main(["--device", device, *args, "-v", "1", "-o", str(tmp / "v1.sam"),
                        str(fa), str(fq)]) == 0, "the CLI run without -v 4 failed")
        wall1 = time.perf_counter() - t0
        check(sam_body(tmp / "v4.sam") == sam_body(tmp / "v1.sam"),
              "the -v 4 run's SAM differs from the run without it")
    rows = {name: int(ns) for name, ns in
            re.findall(r"\[PROFILING\] (.+?) time: (\d+) ns", err.getvalue())}
    for stage in PROFILE_STAGES:
        check(stage in rows, f"-v 4 printed no {stage!r} row: {rows}")
        check(stage == "voting" or rows[stage] > 0, f"-v 4 printed a 0 ns {stage!r} row: {rows}")
    res = {"reads": B, "stage_ns": {s: rows[s] for s in PROFILE_STAGES},
           "other_rows_ns": {k: v for k, v in rows.items() if k not in PROFILE_STAGES},
           "wall_s_v4": wall4, "wall_s_v1": wall1, "sam_identical": True, **counts,
           "card": card}
    say("profile", **res)
    return res


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke run of gdiet_tpu_torch.")
    ap.add_argument("--prev", type=pathlib.Path, default=None,
                    help="a directory with earlier extd2.cu, extd2_fold.cu, vote_scan.cu, "
                         "extd2_band_i16.cu, extd2_i16.cu, vote_lr.cu or extd2_fold_i16.cu "
                         "sources (and the headers they include): time them in turns "
                         "against the checkout's")
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
    prev = build_prev(args.prev) if args.prev is not None else {}
    kv = phase_kernel_vote("cuda", card, built=built,
                           prev=prev["vote_scan"][0] if "vote_scan" in prev else None)
    if "extd2" in prev or "extd2_fold" in prev:
        phase_prev(prev, card, str(args.prev))
    phase_golden("cuda")
    phase_api("cuda", card)
    m = phase_main("cuda", BENCH_B, N_TIMED, GENOME_LEN, card)
    mesh = phase_mesh("cuda", BENCH_B, card)
    if torch.cuda.device_count() >= 2:
        phase_mesh("cuda", BENCH_B, card, distinct=True,
                   shapes=((2, 2),) if torch.cuda.device_count() >= 4 else ((2, 1), (1, 2)))
    else:
        say("mesh_cards", run=False, why=f"{torch.cuda.device_count()} CUDA device visible: "
            "a mesh of distinct cards needs 2 or more (neither a pass nor a failure)")
    phase_multihost(card)
    phase_profile("cuda", BENCH_B, card)
    gen = phase_generic("cuda", GENERIC_READS, card)
    phase_golden_pe(card)
    pe = phase_pe("cuda", PE_PAIRS, PE_TIMED, GENOME_LEN, card)
    kb = phase_kernel_band("cuda", card, built=built)
    glr = phase_golden_lr(card)
    lr, lr_votes = phase_lr("cuda", LR_TIMED, GENOME_LEN, card)
    kvl = phase_kernel_vote_lr("cuda", card, lr_votes, built=built)
    mesh_lr = phase_mesh_lr("cuda", card)
    ont = phase_ont("cuda", ONT_TIMED, GENOME_LEN, card)
    lr_cell = phase_lr_cell("cuda", card)
    if "vote_lr" in prev:
        phase_prev_vote_lr(prev["vote_lr"][0], card, {"hifi": lr_votes, "ont": ont["vote_calls"]})
    del lr_votes
    seeded = seeded_full_calls()
    se_fold = [se_fold_call()]
    k16 = phase_kernel_int16(card, {"se": m["dp_calls"], "generic": gen["dp_calls"],
                                    "pe": pe["dp_calls"], "se_fold": se_fold,
                                    "hifi": lr["dp_calls"], "ont": ont["dp_calls"]}, built, seeded)
    if "extd2_fold_i16" in prev:
        phase_prev_fold_i16(prev["extd2_fold_i16"][0], card,
                            {"pe": pe["dp_calls"][0], "se": se_fold[0]})
    del se_fold
    if "extd2_band_i16" in prev:
        phase_prev_band(prev["extd2_band_i16"][0], card,
                        {"hifi": lr["dp_calls"], "ont": ont["dp_calls"]})
    if "extd2_i16" in prev:
        phase_prev_full(prev["extd2_i16"][0], card,
                        {"se": m["dp_calls"], "generic": gen["dp_calls"], **seeded})
    del seeded
    src = "gdiet_tpu_torch/csrc/"
    hifi = kb["runs"][0]  # band 500: the HiFi workload's budget
    # the SE step's call (160 lanes), held against its plain version; the
    # step's DP checks (main, mesh) count for the kernel of their route
    k16_full = k16["runs"]["se"][0]
    se_kernel = m["dp_kernel"]
    se_errs = [m["step_dp_max_abs_err"]] + [r["dp_max_abs_err"] for r in mesh["runs"]]
    k16_pe = k16["runs"]["pe"][0]
    pe_i16 = pe["step_dp_state_dtype"] == "int16"
    k16_band = next(r for r in k16["runs"]["hifi"]
                    if r["kernel"] == "extd2_band_i16" and "plain_ms" in r)
    kv_main = kv["runs"][0]  # the main phase's stream (M = 130, K = 2)
    kvl1, kvl2 = kvl["round1"], kvl["round2"]  # the HiFi batch's stream (M = 1,026)
    bound_keys = ("bound_ms", "bound_by")
    print(json.dumps({"kernels": [
        {"name": "extd2", "route": "cuda", "source": src + "extd2.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:170",
         "launches": m["extd2_launches"],  # 0 where the SE route takes int16
         "max_abs_err": max([k["max_abs_err"], kb["full_width_bucket"]["max_abs_err"]]
                            + (se_errs if se_kernel == "extd2" else [])),
         "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
         **{x: k[x] for x in bound_keys}, "library_ms": None},
        {"name": "extd2_band", "route": "cuda", "source": src + "extd2_band.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:170",
         "launches": lr["band_launches"] + ont["band_launches"],
         "max_abs_err": max([r["max_abs_err"] for r in kb["runs"]]),
         "ms": hifi["kernel_ms"], "plain_ms": hifi["plain_ms"],
         **{x: hifi[x] for x in bound_keys}, "library_ms": None},
        # the int16 lane state: ms, plain_ms and the bound on the paths'
        # captured calls (kernel_int16), launches on the routes that take them
        {"name": "extd2_i16", "route": "cuda", "source": src + "extd2_i16.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:183",
         "launches": (m["extd2_i16_launches"]
                      + sum(r["full_width_i16_launches"] for r in (lr, ont, *glr.values()))
                      + sum(c["extd2_i16_launches"]
                            for c in gen["launches_and_plain_calls"].values())),
         "max_abs_err": max([int16_err(k16, "extd2_i16")]
                            + (se_errs if se_kernel == "extd2_i16" else [])),
         "ms": k16_full["int16_ms"], "plain_ms": k16_full["plain_ms"],
         **{x: k16_full[x] for x in bound_keys}, "library_ms": None},
        {"name": "extd2_band_i16", "route": "cuda", "source": src + "extd2_band_i16.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:183",
         "launches": sum(r["band_i16_launches"] for r in (lr, ont, lr_cell, *glr.values())),
         "max_abs_err": max(int16_err(k16, "extd2_band_i16"), lr["step_dp"]["max_abs_err"],
                            mesh_lr["step_dp"]["max_abs_err"], lr_cell["max_abs_err"]),
         "ms": k16_band["int16_ms"], "plain_ms": k16_band["plain_ms"],
         **{x: k16_band[x] for x in bound_keys}, "library_ms": None},
        {"name": "extd2_fold_i16", "route": "cuda", "source": src + "extd2_fold_i16.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:428",
         "launches": pe["extd2_fold_i16_launches"],  # the PE route's fold at 160 lanes
         "max_abs_err": max([int16_err(k16, "extd2_fold_i16")]
                            + ([pe["step_dp_max_abs_err"]] if pe_i16 else [])),
         "ms": k16_pe["int16_ms"], "plain_ms": k16_pe["plain_ms"],
         **{x: k16_pe[x] for x in bound_keys}, "library_ms": None},
        {"name": "extd2_fold", "route": "cuda", "source": src + "extd2_fold.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:419",
         "launches": pe["extd2_fold_launches"],  # 0 where the PE route takes int16
         "max_abs_err": max([kf["max_abs_err"], kf_pe["max_abs_err"]]
                            + ([] if pe_i16 else [pe["step_dp_max_abs_err"]])),
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
                               lr["step_dp"]["backtrack_max_abs_err"],
                               mesh_lr["step_dp"]["backtrack_max_abs_err"],
                               lr_cell["backtrack_max_abs_err"]]
                            + [r["backtrack_max_abs_err"] for r in mesh["runs"]]),
         "ms": k["backtrack"]["kernel_ms"], "plain_ms": k["backtrack"]["plain_ms"],
         **{x: k["backtrack"][x] for x in bound_keys}, "library_ms": None},
        {"name": "vote_scan", "route": "cuda", "source": src + "vote_scan.cu",
         "replaces": "gdiet_tpu/pipeline/device_step.py:54",
         "launches": m["vote_launches"],
         "max_abs_err": max([r["max_abs_err"] for r in kv["runs"]]
                            + [r["vote_max_abs_err"] for r in mesh["runs"]]),
         "ms": kv_main["device_ms"] or kv_main["kernel_ms"], "plain_ms": kv_main["plain_ms"],
         **{x: kv_main[x] for x in bound_keys}, "library_ms": None},
        # both entry points per front (round 1, then both round-2 windows);
        # the vote kernels' ms is their profiled device time, where measured
        {"name": "vote_lr", "route": "cuda", "source": src + "vote_lr.cu",
         "replaces": "gdiet_tpu/pipeline/lr_step.py:41",
         "launches": lr["vote_lr_launches"],
         "max_abs_err": max([r[x]["max_abs_err"] for r in (kvl, ont["vote"])
                             for x in ("round1", "round2")]
                            + [mesh_lr["vote_lr_max_abs_err"]]),
         "ms": sum(r["device_ms"] or r["kernel_ms"] for r in (kvl1, kvl2)),
         "plain_ms": kvl1["plain_ms"] + kvl2["plain_ms"],
         "bound_ms": kvl1["bound_ms"] + kvl2["bound_ms"],
         "bound_by": max((kvl1, kvl2), key=lambda r: r["bound_ms"])["bound_by"],
         "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
