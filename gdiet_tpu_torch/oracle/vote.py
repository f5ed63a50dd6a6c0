"""Location-voting oracle (ShortReads single-round voting + recovery).

Semantics re-derived from GDiet-ShortReads/map.c:433-584 (vt_t, vote).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

U32 = (1 << 32) - 1
U64 = (1 << 64) - 1


@dataclass
class Candidate:
    chrom_id: int
    target_loc: int  # int32 semantics: projected location, offset removed
    first_query_loc: int
    last_query_loc: int
    strand: int
    score: int


def _to_i32(v: int) -> int:
    v &= U32
    return v - (1 << 32) if v >= (1 << 31) else v


def vote(
    targets: np.ndarray,
    queries: np.ndarray,
    strand: int,
    potentials: list[Candidate],
    vt_distance: int,
    extracted_len: int,
    tmp_extracted_len: int,
    recovery: list[Candidate],
    vt_threshold: float,
    vt_max_nb_locations: int,
    vt_rec_threshold: float,
):
    """One voting pass over sorted projected hits (map.c:447-584).

    Mutates ``potentials`` (score-insertion-sorted, capped) and ``recovery``
    (zero- or one-element list holding the best sub-threshold run seen so
    far, only considered while ``potentials`` is empty).
    """
    n = len(targets)
    if n == 0:
        return

    def emit(target_loc: int, first_q: int, last_q: int, counter: int) -> bool:
        """Returns False if a full list rejected the run (count too low)."""
        if len(potentials) == vt_max_nb_locations:
            if potentials[-1].score >= counter:
                return False
            potentials.pop()
        off = extracted_len if strand else -(extracted_len + tmp_extracted_len)
        cand = Candidate(
            chrom_id=int(target_loc >> 32),
            target_loc=_to_i32(int(target_loc & U32) + off),
            first_query_loc=first_q,
            last_query_loc=last_q,
            strand=strand,
            score=counter,
        )
        potentials.append(cand)
        k = len(potentials) - 1
        while k > 0 and potentials[k].score > potentials[k - 1].score:
            potentials[k], potentials[k - 1] = potentials[k - 1], potentials[k]
            k -= 1
        return True

    def try_recover(target_loc: int, first_q: int, last_q: int, counter: int):
        if len(potentials) != 0:
            return
        if counter > vt_rec_threshold and (not recovery or counter > recovery[0].score):
            off = extracted_len if strand else -(extracted_len + tmp_extracted_len)
            cand = Candidate(
                chrom_id=int(target_loc >> 32),
                target_loc=_to_i32(int(target_loc & U32) + off),
                first_query_loc=first_q,
                last_query_loc=last_q,
                strand=strand,
                score=counter,
            )
            if recovery:
                recovery[0] = cand
            else:
                recovery.append(cand)

    counter = 1
    target_loc = int(targets[0])
    first_q = int(queries[0])
    last_q = int(queries[0])
    for i in range(1, n):
        cur_t = int(targets[i])
        cur_q = int(queries[i])
        if (cur_t - target_loc) & U64 <= vt_distance:
            counter += 1
            if cur_q < first_q:
                target_loc = cur_t  # run anchor follows the min-query hit
                first_q = cur_q
            if cur_q > last_q:
                last_q = cur_q
        else:
            from gdiet_tpu_torch import debug

            if debug.enabled():  # map.c:480-482
                debug.trace(
                    f"counter: {counter}, {_to_i32(target_loc & U32)},"
                    f" {vt_threshold}, {vt_distance}\n"
                )
            if counter > vt_threshold:
                if not emit(target_loc, first_q, last_q, counter):
                    target_loc, first_q, last_q, counter = cur_t, cur_q, cur_q, 1
                    continue
            else:
                try_recover(target_loc, first_q, last_q, counter)
            target_loc, first_q, last_q, counter = cur_t, cur_q, cur_q, 1

    if counter > vt_threshold:
        emit(target_loc, first_q, last_q, counter)
    else:
        try_recover(target_loc, first_q, last_q, counter)
