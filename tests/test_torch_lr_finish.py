"""The long-read mapper's packed finish (``pipeline/lr_finish.py``) against
``olr.finalize_read``, on the CPU.

Each case is one read's segments with their windows, built from an
alignment written column by column (a seeded genome around the target), and
the DP's result for each as the device hands it over: the packed chunk
(score | fin_i | fin_j | 2-bit back-to-front ops, with pad holes) and the
staged query and target matrices. The packed path (``chunk_results``, then
``finish_read``) must give the ``Reg`` list that ``olr.finalize_read``
gives on the same jobs with the CIGARs of ``cigars_from_ops``, field by
field, and count every finished segment and those it finished per record.

Cases: seeded random ONT-like (3/1/1%) and HiFi-like (0.1/0.05/0.05%)
segments on both strands; an indel whose left shift moves the whole match
before it (``l == prev_len``), for an I and a D; zero-length ops (runs fed
to ``runs_results`` directly: the run-length encoding makes none); a 5I6D7I
run; a leading I (as the ``fin_j`` leftover) and a leading D, on both
strands; ``NEG_INF`` rows; an exact-match segment and a host-DP segment
(per record, as the mapper routes them); two segments of one read that
concatenate; a chunk whose runs overflow (per record).
"""

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.config import options_for
from gdiet_tpu_torch.ops.dp import cigars_from_ops
from gdiet_tpu_torch.oracle import align as oal
from gdiet_tpu_torch.oracle import longread as olr
from gdiet_tpu_torch.pipeline import lr_finish
from gdiet_tpu_torch.pipeline.device_step import pack_ops
from gdiet_tpu_torch.testing import torch_threads

SEED = 2_147_483_711
ONT_RATES = (0.03, 0.01, 0.01)
HIFI_RATES = (0.001, 0.0005, 0.0005)
FLANK = 500
M, I, D = oal.CIGAR_MATCH, oal.CIGAR_INS, oal.CIGAR_DEL
BASE = {"A": 0, "C": 1, "G": 2, "T": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def mo_ont():
    return options_for("map-ont", variant="lr", min_dp_max=200)[1]


class Genome:
    """The oracle view's ``getseq`` over one chromosome."""

    def __init__(self, codes):
        self.codes = codes
        self.lengths = [len(codes)]

    def getseq(self, rid, st, en):
        return self.codes[st:min(en, len(self.codes))].copy()


# ---------------------------------------------------------------------------
# alignments, column by column
# ---------------------------------------------------------------------------
def random_columns(rng, n: int, rates: tuple) -> tuple:
    """(ops, query bases, target bases) of ``n`` columns at (substitution,
    insertion, deletion) rates; a base is -1 where its side has none."""
    sub, ins, dele = rates
    u = rng.random(n)
    ops = np.where(u < ins, I, np.where(u < ins + dele, D, M))
    tb = rng.integers(0, 4, n)
    qb = tb.copy()
    s = (ops == M) & (rng.random(n) < sub)
    qb[s] = (qb[s] + rng.integers(1, 4, int(s.sum()))) % 4
    qb[ops == I] = rng.integers(0, 4, int((ops == I).sum()))
    qb[ops == D] = -1
    tb[ops == I] = -1
    return ops, qb, tb


def scripted(rng, *pieces) -> tuple:
    """Columns from pieces: ("M", n) random exact matches, ("M", "ACG")
    those bases on both sides, ("I", "AC") query bases, ("D", "AC")
    target bases."""
    ops, qb, tb = [], [], []
    for op, what in pieces:
        bases = (rng.integers(0, 4, what).tolist() if isinstance(what, int)
                 else [BASE[c] for c in what])
        for b in bases:
            ops.append({"M": M, "I": I, "D": D}[op])
            qb.append(-1 if op == "D" else b)
            tb.append(-1 if op == "I" else b)
    return np.array(ops), np.array(qb), np.array(tb)


@dataclass
class Seg:
    """One segment: its columns, the route of its DP result, its score."""

    c0: int
    c1: int
    score: int
    route: str = "chunk"  # chunk | neg | exact | host
    lead_fin: bool = False  # a leading I/D run given as the fin_i/fin_j leftover
    next: int | None = None  # the segment it concatenates with


@dataclass
class Case:
    cols: tuple
    segs: list
    strand: int = 0
    overflow: bool = False  # the chunk's runs overflow: every row per record
    runs: bool = False  # feed runs_results the runs, zero-length ops kept
    n_regs: int | None = None
    rng: np.random.Generator = field(default=None, repr=False)


class Read:
    """A case's read, genome and windows."""

    def __init__(self, case: Case):
        ops, qb, tb = case.cols
        rng = case.rng
        self.ops = ops
        query = qb[ops != D].astype(np.uint8)
        target = tb[ops != I].astype(np.uint8)
        self.genome = Genome(np.concatenate([rng.integers(0, 4, FLANK), target,
                                             rng.integers(0, 4, FLANK)]).astype(np.uint8))
        self.qpos = np.concatenate([[0], np.cumsum(ops != D)])
        self.tpos = np.concatenate([[0], np.cumsum(ops != I)])
        self.L = len(query)
        self.strand = case.strand
        # the alignment is on the strand it reads: reverse means qs_rev
        rc = (3 - query[::-1]).astype(np.uint8)
        self.qs_for, self.qs_rev = (rc, query) if case.strand else (query, rc)

    def jobs(self, segs: list) -> tuple:
        """Fresh VtSeqs (windows set, valid, linked) and their jobs."""
        seqs, jobs = [], []
        for g in segs:
            a, b = int(self.qpos[g.c0]), int(self.qpos[g.c1])
            qwin = (self.qs_rev if self.strand else self.qs_for)[a:b]
            ts, te = FLANK + int(self.tpos[g.c0]), FLANK + int(self.tpos[g.c1])
            s = olr.VtSeq(chrom_id=0, str=self.strand)
            s.valid = 1
            s.win = ((self.L - b, self.L - 1 - a) if self.strand else (a, b - 1)) + (ts, te - 1)
            seqs.append(s)
            jobs.append((s, qwin, self.genome.getseq(0, ts, te), g.route == "exact", b - a))
        for s, g in zip(seqs, segs):
            if g.next is not None:
                s.next = seqs[g.next]
        return seqs, jobs


def op_stream(rng, ops: np.ndarray, lead_fin: bool) -> tuple:
    """The DP's back-to-front op stream of columns ``ops`` with pad holes,
    and (fin_i, fin_j): a leading I or D run left over when ``lead_fin``."""
    fin_i = fin_j = -1
    if lead_fin:
        k = int(np.argmax(ops != ops[0])) if (ops != ops[0]).any() else len(ops)
        fin_i, fin_j = (k - 1, -1) if ops[0] == D else (-1, k - 1)
        ops = ops[k:]
    s = ops[::-1].astype(np.uint8)
    holes = np.sort(rng.choice(len(s) + 1, size=min(8, len(s) + 1), replace=False))
    return np.insert(s, holes, 255), fin_i, fin_j


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
def random_case(rates, seed, strand) -> Case:
    rng = np.random.default_rng([SEED, seed])
    n = 6000 if rates is ONT_RATES else 9000
    cols = random_columns(rng, n, rates)
    cuts = np.sort(rng.choice(np.arange(50, n - 50), 7, replace=False))
    edges = [0, *cuts.tolist(), n]
    segs = [Seg(a, b, int(rng.integers(100, 20_000))) for a, b in zip(edges, edges[1:])
            if b - a > 20]
    return Case(cols, segs, strand=strand, rng=rng)


def shift_case(op) -> Case:
    """A gap after a match whose every base equals the gap's tail: the
    left shift empties the match (l == prev_len)."""
    rng = np.random.default_rng([SEED, 11])
    if op == "I":
        cols = scripted(rng, ("M", 60), ("D", "G"), ("M", "AAA"), ("I", "A"), ("M", "C"),
                        ("M", 60))
    else:
        cols = scripted(rng, ("M", 60), ("I", "G"), ("M", "CCC"), ("D", "CC"), ("M", "T"),
                        ("M", 60))
    return Case(cols, [Seg(0, len(cols[0]), 500)], rng=rng)


def zero_len_case() -> Case:
    rng = np.random.default_rng([SEED, 12])
    cols = scripted(rng, ("M", 80), ("D", "TT"), ("M", 5), ("I", "G"), ("M", 80))
    return Case(cols, [Seg(0, len(cols[0]), 600)], runs=True, rng=rng)


def squash_case() -> Case:
    rng = np.random.default_rng([SEED, 13])
    cols = scripted(rng, ("M", 70), ("I", "ACGTA"), ("D", "CCGGTT"), ("I", "TTGCAAC"),
                    ("M", 70))
    return Case(cols, [Seg(0, len(cols[0]), 700)], rng=rng)


def lead_case(strand) -> Case:
    rng = np.random.default_rng([SEED, 14 + strand])
    a = scripted(rng, ("I", "GATC"), ("M", 90), ("D", "A"), ("M", 90))
    b = scripted(rng, ("D", "TTG"), ("M", 120), ("I", "C"), ("M", 60))
    cols = tuple(np.concatenate([x, y]) for x, y in zip(a, b))
    n = len(a[0])
    return Case(cols, [Seg(0, n, 900, lead_fin=True), Seg(n, len(cols[0]), 800)],
                strand=strand, rng=rng)


def neg_case() -> Case:
    c = random_case(ONT_RATES, 21, 0)
    for g in c.segs[1::2]:
        g.score = oal.NEG_INF
        g.route = "neg"
    return c


def exact_case() -> Case:
    """A read under 300 bp: one exact-match window, one DP segment."""
    rng = np.random.default_rng([SEED, 22])
    cols = scripted(rng, ("M", 120), ("M", 40), ("I", "T"), ("M", 80))
    return Case(cols, [Seg(0, 120, 120, route="exact"), Seg(120, len(cols[0]), 300)],
                rng=rng)


def host_case() -> Case:
    c = random_case(HIFI_RATES, 23, 1)
    c.segs[2].route = "host"
    return c


def concat_case() -> Case:
    rng = np.random.default_rng([SEED, 24])
    cols = random_columns(rng, 2600, HIFI_RATES)
    return Case(cols, [Seg(0, 1500, 2400, next=1), Seg(1100, 2600, 2200)], n_regs=1,
                rng=rng)


def overflow_case() -> Case:
    """A segment of 1,300 single-column M and I runs beside ONT-like ones:
    more runs than the chunk's 1,024, so its every row is finished per
    record."""
    c = random_case(ONT_RATES, 25, 1)
    n = len(c.cols[0])
    alt = scripted(c.rng, *[(op, 1) for _ in range(650) for op in ("M", "I")], ("M", 30))
    c.cols = tuple(np.concatenate([x, y]) for x, y in zip(c.cols, alt))
    c.segs.append(Seg(n, len(c.cols[0]), 900))
    c.overflow = True
    return c


CASES = {
    **{f"ont_seed{s}_{'rev' if s % 2 else 'fwd'}": (lambda s=s: random_case(ONT_RATES, s, s % 2))
       for s in range(3)},
    **{f"hifi_seed{s}_{'rev' if s % 2 else 'fwd'}": (lambda s=s: random_case(HIFI_RATES, s, s % 2))
       for s in range(3, 6)},
    "shift_empties_match_I": lambda: shift_case("I"),
    "shift_empties_match_D": lambda: shift_case("D"),
    "zero_length_ops": zero_len_case,
    "squash_5I6D7I": squash_case,
    "leading_I_and_D_fwd": lambda: lead_case(0),
    "leading_I_and_D_rev": lambda: lead_case(1),
    "neg_inf_rows": neg_case,
    "exact_match": exact_case,
    "host_dp": host_case,
    "concatenate": concat_case,
    "overflow_max_runs": overflow_case,
}


# ---------------------------------------------------------------------------
# the two finishes
# ---------------------------------------------------------------------------
def rle(ops: np.ndarray) -> list:
    out = []
    for op in ops.tolist():
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return out


def with_zero_runs(cigar: list) -> list:
    """The CIGAR with a zero-length op before and after every gap."""
    out = []
    for ln, op in cigar:
        if op != M:
            out += [(0, I if op == D else D), (ln, op), (0, op)]
        else:
            out.append((ln, op))
    return out


def stage(case, read, jobs, mo):
    """The chunk's rows (segments of route chunk or neg): the packed result,
    qlens, Q and T as ``_align_jobs_dispatch`` stages them, and each row's
    unfixed CIGAR as the DP gave it."""
    rows = [n for n, g in enumerate(case.segs) if g.route in ("chunk", "neg")]
    streams, cigars = [], []
    for n in rows:
        g = case.segs[n]
        ops = read.ops[g.c0:g.c1]
        if case.runs:
            cigars.append(with_zero_runs(rle(ops)))
            streams.append(op_stream(case.rng, ops, False))
        else:
            s, fi, fj = op_stream(case.rng, ops, g.lead_fin)
            streams.append((s, fi, fj))
            cigars.append(cigars_from_ops(s[None], [fi], [fj], [1])[0])
    N = len(rows)
    S = (max(len(s) for s, _, _ in streams) + 3) // 4 * 4
    op_rows = np.full((N, S), 255, np.uint8)
    for j, (s, _, _) in enumerate(streams):
        op_rows[j, :len(s)] = s
    lq = max(len(jobs[n][1]) for n in rows)
    lt = max(len(jobs[n][2]) for n in rows)
    Q = np.zeros((N, lq), np.uint8)
    T = np.zeros((N, lt), np.uint8)
    qlens = np.zeros(N, np.int32)
    for j, n in enumerate(rows):
        _, qwin, twin, _, _ = jobs[n]
        Q[j, :len(qwin)] = qwin
        T[j, :len(twin)] = twin
        qlens[j] = len(qwin)
    score = np.array([case.segs[n].score for n in rows], np.int32)
    fin = [np.array([x[k] for x in streams], np.int32) for k in (1, 2)]
    packed = np.concatenate([score.view(np.uint8).reshape(N, 4),
                             fin[0].view(np.uint8).reshape(N, 4),
                             fin[1].view(np.uint8).reshape(N, 4),
                             pack_ops(torch.from_numpy(op_rows)).numpy()], 1)
    return rows, packed, qlens, Q, T, cigars


def per_record(case, jobs, mo) -> dict:
    """The exact-match and host-DP segments' results, as the mapper makes
    them."""
    out = {}
    for n, g in enumerate(case.segs):
        _, qwin, twin, _, qlen = jobs[n]
        if g.route == "exact":
            assert np.array_equal(qwin, twin)
            out[n] = (g.score, [(qlen, M)])
        elif g.route == "host":
            ez = oal.extd2(qwin, twin, mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2, mo.bw,
                           mo.zdrop, mo.end_bonus, oal.KSW_EZ_APPROX_MAX)
            out[n] = (ez.score, list(ez.cigar))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_packed_finish_equals_finalize_read(name):
    case = CASES[name]()
    mo = mo_ont()
    read = Read(case)
    args = (read.genome, mo, read.qs_for, read.qs_rev, read.L)

    seqs, jobs = read.jobs(case.segs)
    rows, packed, qlens, Q, T, cigars = stage(case, read, jobs, mo)
    host = per_record(case, jobs, mo)
    ezs = [None] * len(jobs)
    for j, n in enumerate(rows):
        sc = case.segs[n].score
        ezs[n] = (sc, cigars[j] if sc != oal.NEG_INF else [])
    for n, r in host.items():
        ezs[n] = r
    want = olr.finalize_read(*args, seqs, jobs, ezs)

    seqs, jobs = read.jobs(case.segs)
    if case.runs:
        runs = np.zeros((len(rows), max(len(c) for c in cigars)), np.uint32)
        for j, c in enumerate(cigars):
            runs[j, :len(c)] = [(ln << 4) | op for ln, op in c]
        n_runs = np.array([len(c) for c in cigars], np.int64)
        score = packed[:, :4].copy().view(np.int32)[:, 0]
        chunk = lr_finish.runs_results(score, runs, n_runs, Q, T, mo)
    else:
        chunk = lr_finish.chunk_results(packed, qlens, Q, T, mo)
    results = [None] * len(jobs)
    for j, n in enumerate(rows):
        results[n] = chunk[j]
    for n, (sc, cig) in host.items():
        results[n] = (sc, cig, None)
    stats = {"finish_segments": 0, "finish_py_segments": 0}
    got = lr_finish.finish_read(*args, seqs, jobs, results, stats)

    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert want, "the case finishes no segment"
    if case.n_regs is not None:
        assert len(want) == case.n_regs
    live = [g for g in case.segs if g.score != oal.NEG_INF]
    n_py = len(live) if case.overflow else sum(g.route != "chunk" for g in live)
    assert stats == {"finish_segments": len(live), "finish_py_segments": n_py}
    # the packed rows carry CIGARs the fix changed, where the case has any
    if name in ("shift_empties_match_I", "zero_length_ops", "squash_5I6D7I"):
        assert chunk[0][1] != cigars[0]
