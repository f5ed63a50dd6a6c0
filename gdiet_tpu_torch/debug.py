"""Stage-trace debugging — the reference's ``--print-seeds`` oracle.

The reference's main parity-debugging tool is a set of stderr printfs gated
by ``mm_dbg_flag & MM_DBG_PRINT_SEED`` (main.c:289-298) that dump, per read:
the sparsified ("diet") read at each shift (sketch.c:1950-1961, 2195-2214),
per-shift index hit counts (seed.c:176-192), the collected seed hits
(map.c:651-661), vote-run emissions (map.c:480-482), the voted candidate
list (map.c:705-719), each candidate's alignment window and window sequences
(map.c:842-857), and the exact-match query/target/CIGAR (map.c:887-912).

``gdiet --print-seeds`` reproduces the same lines byte-for-byte from the
scalar oracle (single-read path, forced like the reference forces
``n_threads = 1``); ``device_trace`` renders the fused device step's packed
meta tensor in the same vocabulary so oracle and device stage values can be
diffed directly (tests/test_print_seeds.py).
"""

from __future__ import annotations

import sys

PRINT_SEED = False
_OUT = sys.stderr


def set_print_seed(on: bool, out=None) -> None:
    global PRINT_SEED, _OUT
    PRINT_SEED = on
    if out is not None:
        _OUT = out


def trace(msg: str) -> None:
    if PRINT_SEED:
        _OUT.write(msg)


def enabled() -> bool:
    return PRINT_SEED


def device_trace(meta_row: dict, read_name: str, names: list[str]) -> str:
    """Render one read's fused-step meta fields (device_step.unpack_outputs
    row) as a stage trace comparable with the oracle's: the inferred shift,
    extracted length, and each live candidate's chrom/pos/strand/score and
    window geometry."""
    lines = [f"DEV\t{read_name}\tshift: {int(meta_row['shift'])}\t"
             f"extracted: {int(meta_row['extracted'])}\t"
             f"fallback: {int(meta_row['fallback'])}"]
    K = len(meta_row["c_valid"])
    for c in range(K):
        if not meta_row["c_valid"][c]:
            continue
        lines.append(
            "DEVC\t{}\t{}\t{}\t[{}, {}]\t[{}, {}]\tscore: {}\texact: {}"
            .format(
                names[int(meta_row["chrom"][c])],
                "+-"[int(meta_row["c_strand"][c])],
                int(meta_row["ts"][c]) + 1,
                int(meta_row["so"][c]), int(meta_row["eo"][c]),
                int(meta_row["ts"][c]), int(meta_row["te"][c]),
                int(meta_row["dp_score"][c]),
                int(meta_row["exact"][c]),
            )
        )
    return "\n".join(lines) + "\n"
