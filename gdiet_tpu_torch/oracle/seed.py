"""Seeding oracle: query-occurrence filter, index matching, high-occurrence
seed selection, shift inference, and diagonal-projected hit collection.

Semantics re-derived from GDiet-ShortReads/seed.c and map.c:261-431.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gdiet_tpu_torch.oracle.index import OracleIndex

U32 = (1 << 32) - 1


def seed_mz_flt(seeds: list[tuple[int, int]], q_occ_max: int, q_occ_frac: float):
    """mm_seed_mz_flt (seed.c:5-29): drop minimizers whose within-query
    occurrence exceeds both q_occ_max and n*q_occ_frac. In place."""
    n = len(seeds)
    if n <= q_occ_max or q_occ_frac <= 0.0 or q_occ_max <= 0:
        return seeds
    order = sorted(range(n), key=lambda i: seeds[i][0])
    drop = set()
    st = 0
    for i in range(1, n + 1):
        if i == n or seeds[order[i]][0] != seeds[order[st]][0]:
            cnt = i - st
            if cnt > q_occ_max and cnt > n * q_occ_frac:
                for j in range(st, i):
                    drop.add(order[j])
            st = i
    return [s for i, s in enumerate(seeds) if i not in drop]


@dataclass
class Seed:
    """mm_seed_t analog (mmpriv.h): one query minimizer with its index hits."""

    q_pos: int  # packed: real_location<<1 | strand (lower 32 bits of y)
    q_span: int
    hits: np.ndarray  # sorted y values from the index
    n: int
    is_tandem: bool = False
    flt: bool = False


def seed_collect_all(mi: OracleIndex, seeds: list[tuple[int, int]]) -> list[Seed]:
    """mm_seed_collect_all (seed.c:36-62)."""
    out: list[Seed] = []
    for i, (x, y) in enumerate(seeds):
        hits = mi.get(x >> 8)
        if len(hits) == 0:
            continue
        s = Seed(q_pos=y & U32, q_span=x & 0xFF, hits=hits, n=len(hits))
        if i > 0 and (x >> 8) == (seeds[i - 1][0] >> 8):
            s.is_tandem = True
        if i < len(seeds) - 1 and (x >> 8) == (seeds[i + 1][0] >> 8):
            s.is_tandem = True
        out.append(s)
    return out


MAX_MAX_HIGH_OCC = 128


def seed_select(a: list[Seed], qlen: int, max_occ: int, max_max_occ: int, dist: int):
    """mm_seed_select (seed.c:66-106): for each streak of high-occurrence
    minimizers keep only ~(span/dist) of the least-frequent ones. In place."""
    n = len(a)
    if n <= 1:
        return
    if not any(s.n > max_occ for s in a):
        return
    last0 = -1
    for i in range(n + 1):
        if i == n or a[i].n <= max_occ:
            if i - last0 > 1:
                ps = 0 if last0 < 0 else (a[last0].q_pos & U32) >> 1
                pe = qlen if i == n else (a[i].q_pos & U32) >> 1
                st, en = last0 + 1, i
                max_high_occ = int((pe - ps) / dist + 0.499)
                if max_high_occ > 0:
                    max_high_occ = min(max_high_occ, MAX_MAX_HIGH_OCC)
                    # replicate the bounded max-heap of (n<<32|j) keys
                    # (seed.c:86-96) including its tie behaviour
                    b: list[int] = []
                    j = st
                    while j < en and len(b) < max_high_occ:
                        b.append(a[j].n << 32 | j)
                        j += 1
                    import heapq

                    heap = [-v for v in b]
                    heapq.heapify(heap)
                    while j < en:
                        if a[j].n < (-heap[0]) >> 32:
                            heapq.heapreplace(heap, -(a[j].n << 32 | j))
                        j += 1
                    for v in heap:
                        a[(-v) & U32].flt = True
                for j in range(st, en):
                    a[j].flt = not a[j].flt
                for j in range(st, en):
                    if a[j].n > max_max_occ:
                        a[j].flt = True
            last0 = i


def collect_matches(
    mi: OracleIndex,
    seeds: list[tuple[int, int]],
    qlen: int,
    max_occ: int,
    max_max_occ: int,
    dist: int,
) -> list[Seed]:
    """mm_collect_matches2 (seed.c:143-164)."""
    m = seed_collect_all(mi, seeds)
    if dist > 0 and max_max_occ > max_occ:
        seed_select(m, qlen, max_occ, max_max_occ, dist)
    else:
        for s in m:
            if s.n > max_occ:
                s.flt = True
    return [s for s in m if not s.flt]


def get_shift(mi: OracleIndex, seeds: list[tuple[int, int]], counts: list[int]) -> int:
    """mm_get_shift (seed.c:166-194): argmax over shifts of total index hit
    counts of that shift's probe seeds; strict improvement keeps earlier."""
    from gdiet_tpu_torch import debug

    shift = 0
    max_hits = 0
    base = 0
    for i, cnt in enumerate(counts):
        cur = 0
        for kk in range(cnt):
            x, _ = seeds[base + kk]
            t = len(mi.get(x >> 8))
            cur += t
            if debug.enabled():  # seed.c:176-179
                debug.trace(
                    f"mm_get_shift: sketch2's {kk} seed exists {t} time(s),"
                    f" shift {i}\n"
                )
        if debug.enabled():  # seed.c:181-183
            debug.trace(f"mm_get_shift: Shift {i}, nb_locs {cur}\n")
        if cur > max_hits:
            shift, max_hits = i, cur
        base += cnt
    if debug.enabled():  # seed.c:189-191
        debug.trace(f"Final shift: {shift}\n")
    return shift


def _ks_heapdown(i: int, n: int, l: list) -> None:
    """ksort.h ks_heapdown with heap_lt(a,b) = a.x > b.x (map.c:106)."""
    k = i
    tmp = l[i]
    while True:
        k = (k << 1) + 1
        if k >= n:
            break
        if k != n - 1 and l[k][0] > l[k + 1][0]:
            k += 1
        if l[k][0] > tmp[0]:
            break
        l[i] = l[k]
        i = k
    l[i] = tmp


def _heap_merge(runs: list[list[tuple[int, int]]]) -> list[tuple[int, int]]:
    """heap_sort (map.c:143-180): k-way merge of per-seed sorted runs via a
    min-heap keyed on target only — equal targets pop in heap-structure
    order, which the stage traces must reproduce byte-for-byte."""
    src = [x for run in runs for x in run]
    if len(src) <= 1 or len(runs) <= 1:
        return src
    pos = []
    acc = 0
    for r in runs:
        acc += len(r)
        pos.append(acc)
    heap = [(src[0][0], 0, 0)]
    for i in range(1, len(runs)):
        heap.append((src[pos[i - 1]][0], i, 0))
    n = len(heap)
    for i in range((n >> 1) - 1, -1, -1):
        _ks_heapdown(i, n, heap)
    out = []
    heap_size = n
    while heap_size > 0:
        x, unit, off = heap[0]
        base = 0 if unit == 0 else pos[unit - 1]
        out.append((x, src[base + off][1]))
        if base + off < pos[unit] - 1:
            off += 1
            heap[0] = (src[base + off][0], unit, off)
        else:
            heap[0] = heap[heap_size - 1]
            heap_size -= 1
        if heap_size:
            _ks_heapdown(0, heap_size, heap)
    return out


def collect_seed_hits(
    m: list[Seed], tmp_extracted_len: int, heap_sort: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Diagonal projection + sort (map.c:261-431). All three reference sort
    variants (merge/heap/radix, --sort) are order-equivalent for voting —
    ties share the target key — but the --print-seeds SD traces expose the
    tie order, so ``heap_sort`` replicates heap_sort's pop order exactly
    (merge and radix are both stable and equal the stable argsort).

    Returns (targets_fwd, queries_fwd, targets_rev, queries_rev), each sorted
    ascending by target. target = chrom_id << 32 | projected_loc with
    fwd: loc + tmp_extracted_len - qpos, rev: loc + qpos (map.c:294-311).
    """
    runs_f: list[list[tuple[int, int]]] = []
    runs_r: list[list[tuple[int, int]]] = []
    for s in m:
        qpos = (s.q_pos & U32) >> 1
        qstrand = s.q_pos & 1
        rf: list[tuple[int, int]] = []
        rr: list[tuple[int, int]] = []
        for r in s.hits.tolist():
            strand = (r & 1) ^ qstrand
            loc = (r & U32) >> 1
            chrom = r >> 32
            if strand:
                proj = (loc + qpos) & U32
                rr.append(((chrom << 32) | proj, qpos))
            else:
                proj = (loc + tmp_extracted_len - qpos) & U32
                rf.append(((chrom << 32) | proj, qpos))
        if rf:
            runs_f.append(rf)
        if rr:
            runs_r.append(rr)
    if heap_sort:
        flat_f = _heap_merge(runs_f)
        flat_r = _heap_merge(runs_r)
        tf = np.array([x for x, _ in flat_f], dtype=np.uint64)
        qf = np.array([q for _, q in flat_f], dtype=np.uint32)
        tr = np.array([x for x, _ in flat_r], dtype=np.uint64)
        qr = np.array([q for _, q in flat_r], dtype=np.uint32)
        return tf, qf, tr, qr
    tf = np.array([x for run in runs_f for x, _ in run], dtype=np.uint64)
    qf = np.array([q for run in runs_f for _, q in run], dtype=np.uint32)
    tr = np.array([x for run in runs_r for x, _ in run], dtype=np.uint64)
    qr = np.array([q for run in runs_r for _, q in run], dtype=np.uint32)
    of = np.argsort(tf, kind="stable")
    orv = np.argsort(tr, kind="stable")
    return tf[of], qf[of], tr[orv], qr[orv]
