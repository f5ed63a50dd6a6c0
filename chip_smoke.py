#!/usr/bin/env python3
"""On-card smoke run of gdiet_tpu_torch (the PyTorch/CUDA port).

    python3 chip_smoke.py

Needs one CUDA GPU, the CUDA toolkit (nvcc) and a C compiler; imports no
JAX. Phases, each printing one line:

1. device/build: ``nvidia-smi`` name and power limit; every CUDA kernel of
   the main paths built from the checkout's sources, one ``nvcc`` per
   source started together (seconds and ``ptxas -v`` output per kernel).
2. kernel: the CUDA ``extd2`` DP kernel against its plain torch version on
   the card at the short-read main-path shape (6,272 rows, Lmax = Lt = 160,
   qlen 150, bands 150-200; seeded pairs with substitutions, indels, N bases
   and empty rows). Scores and direction bytes must be bit-equal
   (tolerance: exact). Prints both times (the kernel's as the median of 5
   rounds of 10 launches, the plain version's as the better of 2 runs) and
   the kernel's MCUPS.
3. kernel_fold: the folded ``extd2_fold`` kernel against its plain version
   on the same rows (576 kernel rows, 11 passes + drain), then again on the
   rows the PE phase gives it per batch (5,120 rows of 4,096 pairs: 384
   kernel rows, 14 passes): scores, every byte of the raw folded dirs, offs
   and off_ends bit-equal; the folded backtrack of its dirs gives the ops
   and fin_i/fin_j of the unfolded kernel plus the unfolded backtrack.
   Times and MCUPS as in phase 2.
4. golden: ``tests/data`` fixtures (``golden.sam`` and ``golden2_*.sam`` for
   patterns 10, 1110, 11 and 110) mapped on the card through
   ``ShortReadMapper.map_stream_sam``; records must equal the reference
   binary's golden SAM byte for byte.
5. main: the bench workload (2 Mbp genome, 150 bp reads at 0.5%
   substitutions, half reverse-complemented, bench.py's recipe) indexed on
   the card and mapped at the bench budgets, 1 warm-up + 4 timed batches of
   10,016 reads. Kernel launch counts are reset just before and read just
   after. Checks: >= 99% of the mapped primary records within 10 bp of
   where the reference places them (the simulated origin for forward reads;
   origin + k-1 for reverse reads, the reference's reverse-strand window),
   >= 90% of reads mapped, the first unmapped reads unmapped by the scalar
   oracle too, and the first 128 reads' SAM equal to the oracle's.
6. golden_pe: the paired-end fixture (``ref_pe.fa``, ``reads_pe_1.fq`` +
   ``reads_pe_2.fq``) through the port's PE CLI on ``cuda`` with
   ``GDIET_DP_FOLD=1``: records equal the same run on ``cpu`` (the plain
   versions) and on ``cuda`` with the fold off, byte for byte, and the R1
   records match ``golden_pe_r1.sam`` as ``tests/test_pe_parity.py`` checks
   them.
7. pe: the PE path at full width with ``GDIET_DP_FOLD=1``: FR pairs of 150
   bp ends (fragments of 250-500 bp, 0.5% substitutions) from the bench
   genome, 1 warm-up + 3 timed batches of 4,096 pairs at the JAX runtime's
   PE budgets. Launch counts are reset just before and read just after.
   Checks: >= 90% of pairs with both ends mapped, >= 99% of mapped primary
   records where the reference places them, the first 64 pairs equal to
   the oracle's PE finish, the first batch's SAM identical with the fold
   off, fold launches > 0 and no plain-fold call or unfolded launch. The
   DP inputs of one batch, as the step hands them to the fold kernel, go
   through the kernel and the plain fold version once more: bit-equal.

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
KERNEL_ROUNDS = 5  # rounds of 10 launches; the median is reported
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
    from gdiet_tpu_torch import _host

    return _host.config.options_for(
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
    from gdiet_tpu_torch.ops import extd2

    secs = {}
    for name, (_, dt, log) in extd2.build_all(verbose=True).items():
        print(f"[build] {name}.cu: {dt:.2f} s\n{log.strip()}", flush=True)
        secs[name] = dt
    return secs


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


def kernel_vs_plain(kern, plain, cuda: bool):
    """Both versions' outputs and times: 3 warm-up launches (load the
    library, lift the clocks), then plain, 5 rounds of 10 launches, plain.
    One reading of either side alone swings with the host's enqueue
    latency, so the kernel takes the median of the rounds and the plain
    version the better of its two runs."""
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
    plain_out, plain_a = timed(plain, 1)
    rounds = []
    for _ in range(KERNEL_ROUNDS):
        kern_out, ms = timed(kern, 10)
        rounds.append(ms)
    _, plain_b = timed(plain, 1)
    return kern_out, plain_out, {
        "kernel_ms": float(np.median(rounds)), "kernel_ms_rounds": rounds,
        "plain_ms": min(plain_a, plain_b), "plain_ms_runs": [plain_a, plain_b]}


def _max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase_kernel(device, N: int, L: int, qlen: int, card: str) -> dict:
    import torch

    from gdiet_tpu_torch.ops import dp, extd2

    Q, T, lens, band = dp_pairs(N, L, qlen)
    q, t, ln, bd = (torch.from_numpy(a).to(device) for a in (Q, T, lens, band))
    kern_out, plain_out, times = kernel_vs_plain(
        lambda: extd2.extd2_batch(q, t, ln, bd, PARAMS, L),
        lambda: dp.extd2_batch(q, t, ln, bd, PARAMS, L),
        torch.device(device).type == "cuda")
    s_err, d_err = _max_err(kern_out[0], plain_out[0]), _max_err(kern_out[1], plain_out[1])
    check(torch.equal(kern_out[0], plain_out[0]), f"extd2 scores differ (max {s_err})")
    check(torch.equal(kern_out[1], plain_out[1]), f"extd2 dirs differ (max {d_err})")
    check(torch.equal(kern_out[2], plain_out[2]) and torch.equal(kern_out[3], plain_out[3]),
          "extd2 band geometry differs")
    cells = float((lens.astype(np.int64) * lens).sum())
    res = {"rows": N, "Lmax": L, "qlen": qlen, **times,
           "kernel_mcups": cells / (times["kernel_ms"] * 1e3),
           "plain_mcups": cells / (times["plain_ms"] * 1e3),
           "max_abs_err": max(s_err, d_err), "card": card}
    say("kernel", **res)
    return res


def check_fold_equal(kern_out, plain_out, what: str) -> int:
    """Scores, every byte of the raw folded dirs, offs and off_ends of the
    fold kernel bit-equal to the plain fold version's. Returns the largest
    difference (0)."""
    import torch

    errs = [_max_err(a, b) for a, b in zip(kern_out, plain_out)]
    for name, a, b, err in zip(("scores", "dirs", "offs", "off_ends"), kern_out,
                               plain_out, errs):
        check(a.shape == b.shape and torch.equal(a, b),
              f"extd2_fold {name} differ on {what} (max {err})")
    return max(errs)


def pe_dp_rows(P: int) -> int:
    """DP rows the PE step gives the DP per batch of P pairs: 2P read rows
    times K candidates, cut to the dp_frac share (device_step.dp_rows)."""
    from gdiet_tpu_torch.pipeline.device_step import dp_rows

    return dp_rows(2 * P * sr_options()[1].AF_max_loc, 0.3125)


def phase_kernel_fold(device, N: int, L: int, qlen: int, card: str,
                      phase: str = "kernel_fold") -> dict:
    """The folded kernel against its plain version, then fold and unfold
    through their backtracks: the same ops and end points."""
    import torch

    from gdiet_tpu_torch.ops import dp_fold, extd2
    from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

    Q, T, lens, band = dp_pairs(N, L, qlen)
    q, t, ln, bd = (torch.from_numpy(a).to(device) for a in (Q, T, lens, band))
    kern_out, plain_out, times = kernel_vs_plain(
        lambda: extd2.extd2_batch(q, t, ln, bd, PARAMS, L, fold=True),
        lambda: dp_fold.extd2_fold(q, t, ln, bd, PARAMS, L),
        torch.device(device).type == "cuda")
    err = check_fold_equal(kern_out, plain_out, f"{N} rows")
    unfold = extd2.extd2_batch(q, t, ln, bd, PARAMS, L)
    check(torch.equal(unfold[0], kern_out[0]), "folded and unfolded scores differ")
    bt_f = backtrack_antidiag(kern_out[1], ln, bd, L, fold=True)
    bt_u = backtrack_antidiag(unfold[1], ln, bd, L)
    for name, a, b in zip(("ops", "fin_i", "fin_j"), bt_f, bt_u):
        check(torch.equal(a, b), f"folded and unfolded backtracks differ in {name}")
    H, Tf, _ = dp_fold.fold_geometry(L)
    _, Nrows, C = dp_fold.fold_split(N, Tf)
    cells = float((lens.astype(np.int64) * lens).sum())
    res = {"rows": N, "Lmax": L, "qlen": qlen, "kernel_rows": Nrows, "passes": C,
           "H": H, "lanes": Tf, **times,
           "kernel_mcups": cells / (times["kernel_ms"] * 1e3),
           "plain_mcups": cells / (times["plain_ms"] * 1e3),
           "max_abs_err": err, "backtrack_equal_to_unfolded": True,
           "card": card}
    say(phase, **res)
    return res


def _map_sam(mapper, reads) -> list:
    sam = b"".join(bytes(b) for b in mapper.map_stream_sam(iter([reads])))
    return sam.decode().splitlines()


def phase_golden(device) -> dict:
    from gdiet_tpu_torch import _host
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    read_fastx = _host.fastx.read_fastx
    out = {}
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
    say("golden", records=out, identical=True)
    return out


def bench_workload(n_reads: int, genome_len: int = GENOME_LEN):
    """bench.py's recipe (bench.py:63-90), in memory: genome, read origins,
    reverse-strand flags, reads (0.5% substitutions, half
    reverse-complemented)."""
    from gdiet_tpu_torch import _host

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
    SeqRecord = _host.fastx.SeqRecord
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
    sam = _map_sam(mapper, batches[0])  # warm-up batch
    warm = dict(mapper.stats)
    t0 = time.perf_counter()
    for blob in mapper.map_stream_sam(iter(batches[1:])):
        sam += bytes(blob).decode().splitlines()
    sync()
    wall = time.perf_counter() - t0
    launches, plain_calls = extd2.launches.n, dp.calls.n
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
    res = {"reads": n_reads, "timed_reads": B * n_timed, "batch": B,
           "reads_per_s": B * n_timed / wall, "timed_wall_s": wall,
           "index_build_s": index_s,
           "fallback_reads": warm["fallback_reads"] + stats["fallback_reads"],
           "retried_reads": warm.get("retried_reads", 0) + stats.get("retried_reads", 0),
           "extd2_launches": launches, "plain_dp_calls": plain_calls,
           "mapped_reads": len(mapped), "mapped_at_origin": near / len(mapped),
           "unmapped_reads": len(unmapped),
           "unmapped_checked_by_oracle": min(len(unmapped), N_UNMAPPED_ORACLE),
           "oracle_reads_equal": n_or,
           "phase_ms": phases, "card": card}
    say("main", **res)
    return res


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
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, device, fold in (("cuda_fold", "cuda", "1"), ("cpu_fold", "cpu", "1"),
                                   ("cuda_unfold", "cuda", "0")):
            os.environ["GDIET_DP_FOLD"] = fold
            n0 = extd2.fold_launches.n
            out = pathlib.Path(tmp) / f"{name}.sam"
            check(cli.main(["--device", device, *PE_ARGS, "-o", str(out), *inputs]) == 0,
                  f"PE CLI on {device} (fold {fold}) failed")
            runs[name] = sam_body(out)
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
           "r1_checked_against_golden": n_checked, "card": card}
    say("golden_pe", **res)
    return res


def pe_workload(n_pairs: int, genome_len: int = GENOME_LEN):
    """FR pairs from bench_workload's genome: fragments of FRAG_MIN-FRAG_MAX
    bp, 150 bp ends at 0.5% substitutions, half the fragments from the
    reverse strand. Returns (genome, origin [n, 2] leftmost base of each
    end, rev [n, 2] reverse-strand flags, pairs)."""
    from gdiet_tpu_torch import _host

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
    SeqRecord = _host.fastx.SeqRecord
    s1, s2 = bases[R1], bases[R2]
    pairs = [(SeqRecord(f"p{n}/1", s1[n].tobytes().decode(), qual),
              SeqRecord(f"p{n}/2", s2[n].tobytes().decode(), qual)) for n in range(n_pairs)]
    return bases[genome].tobytes().decode(), origin, rev, pairs


def phase_pe(device, P: int, n_timed: int, genome_len: int, card: str) -> dict:
    import torch

    from gdiet_tpu_torch import _host
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
    mo.flag |= _host.config.MM_F_OUT_SAM | _host.config.MM_F_CIGAR  # -a
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
    sam = run(mapper, batches[:1])  # warm-up batch
    first_batch = list(sam)
    warm = dict(mapper.stats)
    t0 = time.perf_counter()
    sam += run(mapper, batches[1:])
    sync()
    wall = time.perf_counter() - t0
    unfold_launches, fold_launches, plain_calls, plain_fold_calls = (c.n for c in counts)
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
    check(run(unfolded, batches[:1]) == first_batch,
          "the first batch's SAM differs with the fold off")

    # ---- per-phase device times of one batch ----
    state = mapper._prepare_pe(batches[1], P)
    sync()
    codes, lens = state[1], state[2]
    phases = per_phase(mapper, codes, lens, cuda, lambda dev, fetched: mapper._finish_pe(
        (*state[:4], dev, *state[5:]), 0, fetched))

    # ---- the fold kernel on the DP inputs the step gives it ----
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
    check(len(seen) == 1 and seen[0][1].get("fold"), "the step made no folded DP call")
    (q, t, ln, bd, params, L), _ = seen[0]
    check(tuple(params) == PARAMS, f"the step's scoring {params} is not {PARAMS}")
    path_err = check_fold_equal(extd2.extd2_batch(q, t, ln, bd, PARAMS, L, fold=True),
                                dp_fold.extd2_fold(q, t, ln, bd, PARAMS, L),
                                "the PE step's DP inputs")
    res = {"pairs": n_pairs, "timed_pairs": P * n_timed, "batch_pairs": P,
           "pairs_per_s": P * n_timed / wall, "timed_wall_s": wall,
           "fallback_pairs": warm["fallback_reads"] + mapper.stats["fallback_reads"],
           "extd2_fold_launches": fold_launches, "extd2_launches": unfold_launches,
           "plain_dp_calls": plain_calls, "plain_fold_calls": plain_fold_calls,
           "pairs_both_mapped": both / n_pairs, "mapped_at_origin": near / len(mapped),
           "step_dp_rows": int(q.shape[0]), "step_dp_live_rows": int((ln > 0).sum()),
           "step_dp_max_abs_err": path_err,
           "oracle_pairs_equal": PE_ORACLE, "first_batch_equal_unfolded": True,
           "phase_ms": phases, "card": card}
    say("pe", **res)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this smoke run needs a GPU", file=sys.stderr)
        return 2
    import gdiet_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    print(card, flush=True)
    build_s = phase_build()
    say("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s)
    k = phase_kernel("cuda", card=card, **KERNEL_SHAPE)
    kf = phase_kernel_fold("cuda", card=card, **KERNEL_SHAPE)
    kf_pe = phase_kernel_fold("cuda", card=card, phase="kernel_fold_pe",
                              **{**KERNEL_SHAPE, "N": pe_dp_rows(PE_PAIRS)})
    phase_golden("cuda")
    m = phase_main("cuda", BENCH_B, N_TIMED, GENOME_LEN, card)
    phase_golden_pe(card)
    pe = phase_pe("cuda", PE_PAIRS, PE_TIMED, GENOME_LEN, card)
    src = "gdiet_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "extd2", "route": "cuda", "source": src + "extd2.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:170",
         "launches": m["extd2_launches"], "max_abs_err": k["max_abs_err"],
         "ms": k["kernel_ms"], "plain_ms": k["plain_ms"]},
        {"name": "extd2_fold", "route": "cuda", "source": src + "extd2_fold.cu",
         "replaces": "gdiet_tpu/ops/dp_pallas.py:419",
         "launches": pe["extd2_fold_launches"],
         "max_abs_err": max(kf["max_abs_err"], kf_pe["max_abs_err"],
                            pe["step_dp_max_abs_err"]),
         "ms": kf["kernel_ms"], "plain_ms": kf["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
