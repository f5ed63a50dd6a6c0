"""Dict-based oracle of the minimizer index.

Semantics re-derived from GDiet-ShortReads/index.c: per-key position lists
sorted ascending by packed y (worker_post, index.c:216-271), lookups by
hash key (mm_idx_get, index.c:84-100), occurrence quantile
(mm_idx_cal_max_occ, index.c:190-210), and 4-bit packed reference sequence
retrieval (mm_idx_getseq/_rev, index.c:157-188).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gdiet_tpu_torch.oracle import sketch as osk


@dataclass
class OracleIndex:
    w: int
    k: int
    pattern: str
    names: list[str] = field(default_factory=list)
    lengths: list[int] = field(default_factory=list)
    seqs: list[np.ndarray] = field(default_factory=list)  # nt4 codes incl. 4=N
    table: dict[int, np.ndarray] = field(default_factory=dict)  # key -> sorted y array
    flag: int = 0

    @property
    def n_seq(self) -> int:
        return len(self.names)

    def get(self, minier: int) -> np.ndarray:
        """mm_idx_get (index.c:84-100): hits for key ``minier`` (= x >> 8)."""
        return self.table.get(minier, np.zeros((0,), dtype=np.uint64))

    def getseq(self, rid: int, st: int, en: int, rev: bool = False) -> np.ndarray:
        """mm_idx_getseq2 (index.c:183-188). ``en`` exclusive, clamped."""
        s = self.seqs[rid]
        en = min(en, len(s))
        if not rev:
            return s[st:en].copy()
        # mm_idx_getseq_rev: reverse-complement of [st, en) in *forward*
        # coordinates measured from the sequence end (index.c:168-181)
        length = len(s)
        frag = s[length - en : length - st][::-1]
        return np.where(frag < 4, 3 - frag, frag).astype(np.uint8)

    def cal_max_occ(self, f: float) -> int:
        """mm_idx_cal_max_occ (index.c:190-210): occurrence quantile."""
        if f <= 0.0:
            return 2**31 - 1
        counts = np.array([len(v) for v in self.table.values()], dtype=np.uint32)
        n = len(counts)
        if n == 0:
            return 2**31 - 1
        idx = int((1.0 - f) * n)
        idx = min(idx, n - 1)
        return int(np.partition(counts, idx)[idx]) + 1


def build_index(
    seqs: dict[str, str] | list[tuple[str, str]],
    w: int,
    k: int,
    pattern: str,
) -> OracleIndex:
    """Index construction oracle (mm_idx_gen + worker_post semantics)."""
    items = list(seqs.items()) if isinstance(seqs, dict) else list(seqs)
    mi = OracleIndex(w=w, k=k, pattern=pattern)
    acc: dict[int, list[int]] = {}
    for rid, (name, seq) in enumerate(items):
        codes = osk.seq_to_code(seq)
        mi.names.append(name)
        mi.lengths.append(len(codes))
        mi.seqs.append(codes)
        for x, y in osk.sketch_index(codes, w, k, rid, pattern):
            acc.setdefault(x >> 8, []).append(y)
    for key, ys in acc.items():
        # worker_post sorts each key's positions ascending (index.c:255-257)
        mi.table[key] = np.sort(np.array(ys, dtype=np.uint64))
    return mi


def derive_mid_occ(mi: OracleIndex, mo) -> int:
    """mm_mapopt_update (options.c:64-76)."""
    if mo.mid_occ > 0:
        return mo.mid_occ
    mid = mi.cal_max_occ(mo.mid_occ_frac)
    mid = max(mid, mo.min_mid_occ)
    if mo.max_mid_occ > mo.min_mid_occ:
        mid = min(mid, mo.max_mid_occ)
    return mid
