#!/usr/bin/env python3
"""On-card smoke run of gdiet_tpu_torch (the PyTorch/CUDA port).

    python3 chip_smoke.py

Needs one CUDA GPU, the CUDA toolkit (nvcc) and a C compiler; imports no
JAX. Phases, each printing one line:

1. device: ``nvidia-smi`` name and power limit; build every CUDA kernel of
   the main path from the checkout's sources (timed).
2. kernel: the CUDA ``extd2`` DP kernel against its plain torch version on
   the card at the short-read main-path shape (6,272 rows, Lmax = Lt = 160,
   qlen 150, bands 150-200; seeded pairs with substitutions, indels, N bases
   and empty rows). Scores and direction bytes must be bit-equal
   (tolerance: exact). Prints both times (the kernel's as the median of 5
   rounds of 10 launches, the plain version's as the better of 2 runs) and
   the kernel's MCUPS.
3. golden: ``tests/data`` fixtures (``golden.sam`` and ``golden2_*.sam`` for
   patterns 10, 1110, 11 and 110) mapped on the card through
   ``ShortReadMapper.map_stream_sam``; records must equal the reference
   binary's golden SAM byte for byte.
4. main: the bench workload (2 Mbp genome, 150 bp reads at 0.5%
   substitutions, half reverse-complemented, bench.py's recipe) indexed on
   the card and mapped at the bench budgets, 1 warm-up + 4 timed batches of
   10,016 reads. Kernel launch counts are reset just before and read just
   after. Checks: >= 99% of the mapped primary records within 10 bp of
   where the reference places them (the simulated origin for forward reads;
   origin + k-1 for reverse reads, the reference's reverse-strand window),
   >= 90% of reads mapped, the first unmapped reads unmapped by the scalar
   oracle too, and the first 128 reads' SAM equal to the oracle's.

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
def phase_build() -> float:
    from gdiet_tpu_torch.ops import extd2

    _, secs, log = extd2.build(verbose=True)
    if log:
        print(log.strip(), file=sys.stderr)
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


def phase_kernel(device, N: int, L: int, qlen: int, card: str) -> dict:
    import torch

    from gdiet_tpu_torch.ops import dp, extd2

    Q, T, lens, band = dp_pairs(N, L, qlen)
    q, t = torch.from_numpy(Q).to(device), torch.from_numpy(T).to(device)
    ln, bd = torch.from_numpy(lens).to(device), torch.from_numpy(band).to(device)
    params = (2, 8, 12, 2, 24, 1)  # the sr preset's scoring
    cuda = torch.device(device).type == "cuda"

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

    kern = lambda: extd2.extd2_batch(q, t, ln, bd, params, L)  # noqa: E731
    plain = lambda: dp.extd2_batch(q, t, ln, bd, params, L)  # noqa: E731
    for _ in range(3):  # warm-up: loads the library, lifts the clocks
        kern()
    # plain, kernel rounds, plain: one reading of either side alone swings
    # with the host's enqueue latency, so the kernel takes a median
    plain_out, plain_a = timed(plain, 1)
    rounds = []
    for _ in range(KERNEL_ROUNDS):
        kern_out, ms = timed(kern, 10)
        rounds.append(ms)
    _, plain_b = timed(plain, 1)
    kern_ms = float(np.median(rounds))
    plain_ms = min(plain_a, plain_b)
    s_err = int((kern_out[0].long() - plain_out[0].long()).abs().max())
    d_err = int((kern_out[1].int() - plain_out[1].int()).abs().max())
    check(torch.equal(kern_out[0], plain_out[0]), f"extd2 scores differ (max {s_err})")
    check(torch.equal(kern_out[1], plain_out[1]), f"extd2 dirs differ (max {d_err})")
    check(torch.equal(kern_out[2], plain_out[2]) and torch.equal(kern_out[3], plain_out[3]),
          "extd2 band geometry differs")
    cells = float((lens.astype(np.int64) * lens).sum())
    res = {"rows": N, "Lmax": L, "qlen": qlen, "kernel_ms": kern_ms,
           "kernel_ms_rounds": rounds, "plain_ms": plain_ms,
           "plain_ms_runs": [plain_a, plain_b],
           "kernel_mcups": cells / (kern_ms * 1e3),
           "plain_mcups": cells / (plain_ms * 1e3), "max_abs_err": max(s_err, d_err),
           "card": card}
    say("kernel", **res)
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
    native = mapper.native
    codes, lens = native.encode_batch([r.seq for r in batches[1]], 160)
    phases = per_phase(mapper, batches[1], codes, lens, cuda)
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


def per_phase(mapper, batch, codes, lens, cuda: bool) -> dict:
    """Device time of each step phase for one batch (CUDA events at the
    phase boundaries), then D2H and the native host finish (host clock)."""
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
    fetched = mapper.fused.fetch(dev, len(batch))
    out["d2h"] = (time.perf_counter() - t0) * 1e3
    n = len(batch)
    blobs = mapper.native.make_sr_blobs([r.name for r in batch], [r.seq for r in batch],
                                        [r.qual or "" for r in batch])
    state = (batch, codes, lens, np.zeros(n, bool), np.arange(n), dev, blobs, n)
    t0 = time.perf_counter()
    mapper._finish_sam(state, 0, fetched)
    out["host_finish"] = (time.perf_counter() - t0) * 1e3
    return out


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
        extd2_build_s=build_s)
    k = phase_kernel("cuda", card=card, **KERNEL_SHAPE)
    phase_golden("cuda")
    m = phase_main("cuda", BENCH_B, N_TIMED, GENOME_LEN, card)
    print(json.dumps({"kernels": [{
        "name": "extd2", "route": "cuda", "source": "gdiet_tpu_torch/csrc/extd2.cu",
        "replaces": "gdiet_tpu/ops/dp_pallas.py:170",
        "launches": m["extd2_launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "plain_ms": k["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
