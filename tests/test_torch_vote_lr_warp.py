"""The decomposition of ``csrc/vote_lr.cu`` (one warp per read half, 32
columns a step), as a small numpy model, against the port's plain loops
(``lr_step._vote_scan_lr``, ``lr_step.vote2_packed_pair``) and gdiet_tpu's
scans (``_vote_scan_lr``, ``_vote2_scan``) on the CPU.

The model does what the kernel does, step by step: each half of a read is
walked 32 columns at a time (the warp's lanes) up to its first invalid
column (the streams are valid-first). A step scans the query positions
with an exclusive first-argmin scan (Hillis-Steele over lane offsets 1, 2,
4, 8, 16, ties kept by the left element, as ``__shfl_up_sync`` gives it),
whose element -1 is the carried run (fq, ref_loc); so each column learns
the key it is tested against. A ballot of the columns whose unsigned
distance ``t - ref`` exceeds vt_distance gives the first break; the
columns before it join the run at once (count, max lq, unsigned min/max
raw target), the break starts a new run, and the scan restarts after it.
Round 1 inserts each gated run's end into its half's K-list (one backward
bubble pass); the two lists are merged stably, forward first, by each
element's output position. Round 2 runs both windows' scans (in-window
columns only move fq, ref_loc, lq and the raw span; a run restarts at any
breaking column and its start counts whatever its window) and keeps the
reverse half's best run only where its count is strictly greater.

Cases: the seeded ``lr_streams`` (valid-first) and streams made to hit
each trap: runs crossing a step, a q tie at the minimum (inside a step and
against the carried run), keys below ref_loc (the unsigned wrap), every
column its own run, one run of more than 64 columns, K = 1 and K = 40 on
full lists with ties, empty halves, windows that exclude a run's start
column. Tolerance: exact, on every output.
"""

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import vote
from gdiet_tpu_torch.testing import torch_threads
from test_torch_vote_lr import (U64_MAX, _jax_args, _t, lr_streams, plain_pair,
                                plain_round1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


LANES = 32
I32_MAX = np.int64(2**31 - 1)
LANE = np.arange(LANES)


# ---------------------------------------------------------------------------
# the model of one warp
# ---------------------------------------------------------------------------
def argmin_scan(q, live):
    """Inclusive first-argmin scan of q over the warp's lanes: (q, lane) of
    the first smallest q among the live lanes up to each lane; a lane that
    is not live holds I32_MAX (it never wins against a live lane or the
    carried run)."""
    qv = np.where(live, q, I32_MAX)
    iv = LANE.copy()
    for d in (1, 2, 4, 8, 16):
        qo = np.concatenate([qv[:d], qv[:-d]])  # __shfl_up_sync
        io = np.concatenate([iv[:d], iv[:-d]])
        take = (LANE >= d) & (qo <= qv)  # the left element wins ties
        qv, iv = np.where(take, qo, qv), np.where(take, io, iv)
    return qv, iv


class Run:
    def __init__(self, t, q, raw):
        self.fq = self.lq = int(q)
        self.ref, self.ft, self.lt = np.uint64(t), np.uint64(raw), np.uint64(raw)
        self.cnt = 1


def walk_half(t, q, raw, dist, window, on_end) -> dict:
    """Walk one valid-first half (t, raw uint64 [n], q int64 [n]) as the
    warp does; ``window`` (lo, hi) restricts what moves the run (round 2),
    None counts every column (round 1); ``on_end(run)`` at every run's end.
    Returns the warp's scan iterations and the longest run's columns."""
    n = len(t)
    run, iters, span, longest = None, 0, 0, 0
    for c0 in range(0, n, LANES):
        end = min(LANES, n - c0)
        tt = np.zeros(LANES, np.uint64)
        qq = np.zeros(LANES, np.int64)
        rr = np.zeros(LANES, np.uint64)
        tt[:end], qq[:end], rr[:end] = t[c0:c0 + end], q[c0:c0 + end], raw[c0:c0 + end]
        inwin = np.ones(LANES, bool) if window is None else (qq > window[0]) & (qq < window[1])
        s = 0
        if run is None:  # the half's first column starts a run
            run, s, span = Run(tt[0], qq[0], rr[0]), 1, 1
        while s < end:
            iters += 1
            inside = (LANE >= s) & (LANE < end)
            qv, iv = argmin_scan(qq, inside & inwin)
            eq = np.concatenate([[I32_MAX], qv[:-1]])  # exclusive: lane i sees lanes < i
            ei = np.concatenate([[0], iv[:-1]])
            ref = np.where(run.fq <= eq, run.ref, tt[ei])  # the carried run is element -1
            brk = inside & ((tt - ref) > np.uint64(dist))  # unsigned 64-bit wrap
            j = int(np.argmax(brk)) if brk.any() else end  # the ballot's first break
            joined = (LANE >= s) & (LANE < j)
            jw = joined & inwin
            run.cnt += int(jw.sum())
            if jw.any():
                run.lq = max(run.lq, int(qq[jw].max()))
                run.ft = min(run.ft, rr[jw].min())
                run.lt = max(run.lt, rr[jw].max())
            span += j - s
            if j > s and qv[j - 1] < run.fq:  # the inclusive scan at j - 1
                run.fq, run.ref = int(qv[j - 1]), tt[iv[j - 1]]
            if j < end:
                on_end(run)
                longest = max(longest, span)
                run, s, span = Run(tt[j], qq[j], rr[j]), j + 1, 1
            else:
                s = end
    if run is not None:
        on_end(run)
        longest = max(longest, span)
    return {"iters": iters, "longest_run": longest}


def half_streams(s: dict, b: int):
    """(t, q, raw) of each half of row b, up to its first invalid column."""
    A = (s["keys"].shape[1] - 2) // 2
    ex = np.uint64(s["extracted"][b])
    out = []
    for h in range(2):
        off = h * (A + 1)
        ok = s["valid"][b, off:off + A]
        n = int(np.argmin(ok)) if not ok.all() else A
        t = s["keys"][b, off:off + n]
        q = s["qpos"][b, off:off + n].astype(np.int64)
        qq = q.astype(np.uint64)  # sign-extended, as the kernel's (uint64)(int64)q
        raw = t - qq if h else t - (ex - qq)
        out.append((t, q, raw))
    return out


def i32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def model_round1(s: dict, K: int) -> tuple:
    """The round-1 outputs of every row as the kernel computes them, and
    the warp iterations of each half."""
    B = s["keys"].shape[0]
    o = {"k_score": np.full((B, K), -1, np.int32), "k_first_t": np.zeros((B, K), np.uint64),
         "k_last_t": np.zeros((B, K), np.uint64), "k_fq": np.zeros((B, K), np.int32),
         "k_lq": np.zeros((B, K), np.int32), "k_str": np.zeros((B, K), np.int32),
         "out_len": np.zeros(B, np.int32)}
    stats = []
    for b in range(B):
        lists = []
        for h, (t, q, raw) in enumerate(half_streams(s, b)):
            lst = []

            def emit(run, h=h, lst=lst):
                if i32(run.lq - run.fq) <= int(s["cov_thr"][b]):
                    return
                if len(lst) == K and lst[-1][0] >= run.cnt:
                    return
                item = (run.cnt, run.ft, run.lt, run.fq, run.lq, h)
                if len(lst) == K:
                    lst[-1] = item
                else:
                    lst.append(item)
                k = len(lst) - 1
                while k > 0 and lst[k][0] > lst[k - 1][0]:  # one backward bubble pass
                    lst[k], lst[k - 1] = lst[k - 1], lst[k]
                    k -= 1

            stats.append(walk_half(t, q, raw, s["vt_distance"][b], None, emit))
            lists.append(lst)
        fwd, rev = lists
        n = min(K, len(fwd) + len(rev))
        # the merge: each element's position in the stable order, forward first
        for i, e in enumerate(fwd):
            p = i + sum(r[0] > e[0] for r in rev)
            if p < K:
                _put(o, b, p, e)
        for j, e in enumerate(rev):
            p = j + sum(f[0] >= e[0] for f in fwd)
            if p < K:
                _put(o, b, p, e)
        o["out_len"][b] = n
    return o, stats


def _put(o, b, p, e):
    cnt, ft, lt, fq, lq, h = e
    o["k_score"][b, p], o["k_first_t"][b, p], o["k_last_t"][b, p] = cnt, ft, lt
    o["k_fq"][b, p], o["k_lq"][b, p], o["k_str"][b, p] = fq, lq, h


def model_round2(s: dict) -> tuple:
    """The [B, 16] packed round-2 block of both windows as the kernel
    computes it, and the warp iterations of each (half, window)."""
    B = s["keys"].shape[0]
    out = np.zeros((B, 16), np.int64)
    stats = []
    for b in range(B):
        for w, (lo, hi) in enumerate(((s["lo1"][b], s["hi1"][b]), (s["lo2"][b], s["hi2"][b]))):
            best = []
            for h, (t, q, raw) in enumerate(half_streams(s, b)):
                hb = [0, 0, 0, 0, np.uint64(0), np.uint64(0)]  # no run: zeros

                def consider(run, h=h, hb=hb):
                    if run.cnt > hb[0] and run.lq < hi and run.fq > lo:
                        hb[:] = [run.cnt, run.fq, run.lq, h, run.ft, run.lt]

                stats.append(walk_half(t, q, raw, s["vt_distance"][b], (int(lo), int(hi)),
                                       consider))
                best.append(hb)
            f, r = best
            pick = r if r[0] > f[0] else f  # the reverse half only where strictly better
            ft, lt = int(pick[4]), int(pick[5])
            out[b, 8 * w:8 * w + 8] = [pick[0], pick[1], pick[2], pick[3], i32(ft >> 32),
                                       i32(ft & 0xFFFFFFFF), i32(lt >> 32), i32(lt & 0xFFFFFFFF)]
    return out.astype(np.int32), stats


# ---------------------------------------------------------------------------
# streams made to hit each trap (valid-first halves, one shape for all)
# ---------------------------------------------------------------------------
A_CASE = 136  # columns per half: four full steps and a partial one


def make_stream(rows: list, seed: int, A: int = A_CASE) -> dict:
    """A stream of explicit rows, A columns a half: each a dict with 'fwd'
    and 'rev' (lists of (key, q)), and optional 'cov', 'dist', 'ex',
    'win1', 'win2'."""
    rng = np.random.default_rng(seed)
    B = len(rows)
    M = 2 * (A + 1)
    s = {"keys": np.full((B, M), U64_MAX, np.uint64), "qpos": np.zeros((B, M), np.int32),
         "valid": np.zeros((B, M), bool),
         "strand": np.array([0] * (A + 1) + [1] * (A + 1), np.int32),
         "extracted": rng.integers(200, 6000, B).astype(np.int64),
         "vt_distance": np.zeros(B, np.uint64), "cov_thr": np.zeros(B, np.int32)}
    for n in ("lo1", "hi1", "lo2", "hi2"):
        s[n] = np.zeros(B, np.int32)
    for b, row in enumerate(rows):
        for h, name in enumerate(("fwd", "rev")):
            hits = row.get(name, [])
            assert len(hits) <= A
            off = h * (A + 1)
            for c, (k, q) in enumerate(hits):
                s["keys"][b, off + c] = np.uint64(k % 2**64)
                s["qpos"][b, off + c] = q
                s["valid"][b, off + c] = True
        s["vt_distance"][b] = row.get("dist", 500)
        s["cov_thr"][b] = row.get("cov", 3)
        if "ex" in row:
            s["extracted"][b] = row["ex"]
        s["lo1"][b], s["hi1"][b] = row.get("win1", (0, 400))
        s["lo2"][b], s["hi2"][b] = row.get("win2", (40, 300))
    return s


def cluster(base: int, qs, step: int = 3):
    """A run: keys base, base + step, ... with query positions qs."""
    return [(base + i * step, int(q)) for i, q in enumerate(qs)]


def far(i: int) -> int:
    return (1 << 32) + 100_000 * i  # beyond any vt_distance of these rows


def case_rows(name: str) -> list:
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    if name == "cross_step":  # runs across the 32- and 64-column boundaries
        return [{"fwd": cluster(far(0), range(20)) + cluster(far(1), range(5, 45))
                 + cluster(far(2), range(30)), "rev": cluster(far(3), range(10, 50)),
                 "cov": 5},
                {"fwd": cluster(far(4), range(31)) + cluster(far(5), range(2)),
                 "rev": cluster(far(6), range(32)) + cluster(far(7), range(33))}]
    if name == "q_tie_min":  # the first argmin, never the last
        # q 5 at keys base+100 and base+400: a later key base+650 is within
        # 500 of the first only if ref stays at the first
        tie = [(far(0), 10), (far(0) + 100, 5), (far(0) + 200, 7), (far(0) + 400, 5),
               (far(0) + 650, 9), (far(0) + 700, 8)]
        # the same across a step: the carried run's q 5 (column 30) ties a
        # lane's q 5 (column 33) in the next step
        carry = ([(far(1) + i, 20 + i) for i in range(30)] + [(far(1) + 40, 5), (far(1) + 41, 6),
                  (far(1) + 42, 7), (far(1) + 430, 5), (far(1) + 560, 11)])
        return [{"fwd": tie, "rev": carry, "cov": 0},
                {"fwd": carry, "rev": tie[::-1], "cov": 0}]
    if name == "wrap":  # t - ref wraps: a key below ref breaks the run
        return [{"fwd": [(far(0) + 50, 4), (far(0) + 40, 9), (far(0) + 60, 3), (far(0) + 55, 1),
                         (far(0) + 70, 8)], "rev": [(100, 3), (50, 7), (120, 2)], "cov": 0},
                {"fwd": [(5, 1), (3, 2), (2**64 - 1, 3), (0, 4)], "ex": 10, "cov": -1,
                 "rev": [(7, 5), (6, 1)]}]
    if name == "own_runs":  # every column its own run (gated with cov -1)
        return [{"fwd": [(far(i), i) for i in range(70)], "rev": [(far(100 + i), 70 - i)
                                                                 for i in range(45)],
                 "cov": -1, "win1": (0, 60), "win2": (10, 50)}]
    if name == "long_run":  # one run of 130 columns, then a short one
        return [{"fwd": cluster(far(0), rng.integers(0, 2000, 130), step=1) + cluster(far(1), [3]),
                 "rev": cluster(far(2), rng.integers(0, 2000, 100), step=2),
                 "dist": 1000, "win1": (0, 1000), "win2": (500, 1900)}]
    if name == "full_lists":  # more gated runs than slots, counts tied
        fwd, rev = [], []
        for i in range(30):
            fwd += cluster(far(i), [10 + i, 14 + i, 20 + i][: 1 + i % 3])
        for i in range(28):
            rev += cluster(far(100 + i), [5, 9, 30][: 1 + (i + 1) % 3])
        return [{"fwd": fwd[:A_CASE], "rev": rev[:A_CASE], "cov": -1}]
    if name == "empty_halves":
        return [{"fwd": [], "rev": cluster(far(0), [1, 9, 20])},
                {"fwd": cluster(far(1), [3, 30, 8]), "rev": []},
                {"fwd": [], "rev": []},
                {"fwd": [(far(2), 7)], "rev": [(far(3), 9)], "cov": -1}]
    if name == "window_start":  # the start column outside the window
        return [{"fwd": [(far(0), 500), (far(0) + 5, 50), (far(0) + 9, 60), (far(0) + 12, 70)],
                 "rev": [(far(1), 2), (far(1) + 3, 50), (far(1) + 6, 80)],
                 "win1": (10, 400), "win2": (40, 100)},
                {"fwd": [(far(2), 45), (far(2) + 5, 50), (far(2) + 8, 600)]
                 + [(far(2) + 9 + i, 60 + i) for i in range(40)],
                 "rev": [(far(3) + i, 300 - i) for i in range(50)],
                 "win1": (44, 90), "win2": (260, 299)}]
    raise KeyError(name)


def ont_rows(B: int, seed: int) -> list:
    """Rows shaped like the ONT front's halves (vote budget 4,096): one run
    of ~600 columns and runs of ~100-200, query positions over a 30 kb
    read, vt_distance 1000."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        row = {"dist": 1000, "cov": 300, "win1": (0, 3000), "win2": (20000, 30000)}
        for name in ("fwd", "rev"):
            hits, i = [], 0
            for n in ([600] if b % 2 == 0 else []) + list(rng.integers(60, 220, 3)):
                qs = np.sort(rng.integers(0, 30000, n))
                key = far(i + 10 * b) + np.cumsum(rng.integers(0, 6, n))
                hits += [(int(k), int(q)) for k, q in zip(key, qs if name == "rev" else qs[::-1])]
                i += 1
            row[name] = hits
        rows.append(row)
    return rows


CASES = ["cross_step", "q_tie_min", "wrap", "own_runs", "long_run", "full_lists",
         "empty_halves", "window_start"]


def _check(s: dict, K: int):
    """The model against the port's plain loops and gdiet_tpu's scans:
    round 1 at K and both round-2 windows, exact. Returns the model's
    per-half statistics."""
    import jax.numpy as jnp

    from gdiet_tpu.pipeline.lr_step import _vote2_scan, _vote_scan_lr

    got1, st1 = model_round1(s, K)
    plain1 = plain_round1(s, K)
    jax1 = _vote_scan_lr(*_jax_args(s), jnp.asarray(s["cov_thr"]), K=K)
    for name in vote.LR_OUTPUTS:
        have = got1[name]
        p = plain1[name].numpy()
        if name.endswith("_t"):
            p = p.view(np.uint64)
        assert np.array_equal(have, p), ("plain", name)
        assert np.array_equal(have, np.asarray(jax1[name])), ("jax", name)
    got2, st2 = model_round2(s)
    assert np.array_equal(got2, plain_pair(s).numpy())
    for w, (lo, hi) in enumerate((("lo1", "hi1"), ("lo2", "hi2"))):
        ref = _vote2_scan(*_jax_args(s), jnp.asarray(s[lo]), jnp.asarray(s[hi]))
        ft, lt = (np.asarray(ref[n]).astype(np.uint64) for n in ("b_first_t", "b_last_t"))
        packed = np.stack([np.asarray(ref["b_score"]), np.asarray(ref["b_fq"]),
                           np.asarray(ref["b_lq"]), np.asarray(ref["b_str"]),
                           (ft >> np.uint64(32)).astype(np.uint32).view(np.int32),
                           ft.astype(np.uint32).view(np.int32),
                           (lt >> np.uint64(32)).astype(np.uint32).view(np.int32),
                           lt.astype(np.uint32).view(np.int32)], 1)
        assert np.array_equal(got2[:, 8 * w:8 * w + 8], packed), ("jax", lo)
    return got1, st1, got2, st2


@pytest.mark.parametrize("case,K", [(c, K) for c in CASES for K in (1, 5)]
                         + [("full_lists", 40), ("own_runs", 40),
                            ("seeded", 1), ("seeded", 3), ("seeded", 5), ("seeded", 40),
                            ("seeded_wide", 5)])
def test_warp_model_matches_plain_and_jax(case, K):
    if case == "seeded":
        s = lr_streams(48, A_CASE, 31 + K, holes=False)
    elif case == "seeded_wide":  # longer halves: runs across several steps
        s = lr_streams(24, 600, 37, holes=False)
    else:
        s = make_stream(case_rows(case), 41)
    got1, st1, got2, st2 = _check(s, K)
    iters = [x["iters"] for x in st1]
    longest = max(x["longest_run"] for x in st1)
    if case == "cross_step":
        assert longest >= 40 and max(iters) >= 4
    elif case == "long_run":
        assert longest > 64
    elif case == "own_runs":  # one scan iteration per column after the first
        assert iters[0] == 69 and (got1["out_len"] == min(K, 115)).all()
    elif case == "full_lists":
        assert (got1["out_len"] == K).all()
        ks = got1["k_score"][0]
        assert K == 1 or (ks[1:] == ks[:-1]).any()  # tied counts kept in order
        assert K < 40 or set(got1["k_str"][0]) == {0, 1}  # both halves' lists merged
    elif case == "empty_halves":
        assert got1["out_len"][2] == 0 and (got2[2] == 0).all()
    elif case == "window_start":
        assert (got2[:, 0] > 0).any() or (got2[:, 8] > 0).any()
    elif case.startswith("seeded"):
        assert (got1["out_len"] > 0).any() and (got2[:, 0] > 0).any()


def test_trap_cases_reach_their_branch():
    """Each hand-made case moves the result the way its trap says: the
    first argmin (q_tie_min) and the unsigned wrap (wrap) break runs where
    the last argmin or a signed test would not."""
    s = make_stream(case_rows("q_tie_min"), 41)
    got, _ = model_round1(s, 5)
    # row 0's forward run breaks at key base+650 (650 > 500 from the first
    # q 5's key base+100 is 550): two runs, 4 and 2 columns
    sc, st = got["k_score"][0], got["k_str"][0]
    assert sorted(sc[(st == 0) & (sc > 0)].tolist()) == [2, 4]
    s = make_stream(case_rows("wrap"), 41)
    got, _ = model_round1(s, 5)
    fwd = got["k_score"][0][(got["k_str"][0] == 0) & (got["k_score"][0] > 0)]
    # keys below ref break the run: three runs (the first ungated), where a
    # signed distance test would make one run of five columns
    assert sorted(fwd.tolist()) == [2, 2]
    # the raw target's wrap on the forward half: small keys, extracted 10
    assert (got["k_first_t"][1] > np.uint64(2**63)).any()
