"""Helpers shared by the port's tests and ``chip_smoke.py``: SAM
comparisons, and the CPU thread count of the tests."""

from __future__ import annotations

import contextlib
import pathlib

import torch

PE_BITS = 0x1 | 0x2 | 0x8 | 0x20 | 0x40 | 0x80  # FLAG bits that pairing sets


def sam_body(path) -> list:
    """The records of a SAM file, header lines dropped."""
    return [l for l in pathlib.Path(path).read_text().splitlines() if not l.startswith("@")]


def r1_vs_single_end(pe_records: list, golden_records: list) -> tuple[int, list]:
    """Hold the R1 records of a paired-end SAM body against the reference's
    single-end golden for the R1 file, as ``tests/test_pe_parity.py`` does:
    every mapped primary golden record must match its R1 record except for
    what pairing rewrites (the FLAG's PE bits, MAPQ, the mate columns).
    Returns (records checked, names of the records that differ)."""
    mine = {}
    for f in (l.split("\t") for l in pe_records):
        if int(f[1]) & 0x40 and not int(f[1]) & 0x900:
            mine[f[0]] = f
    n_checked, bad = 0, []
    for g in (l.split("\t") for l in golden_records):
        if int(g[1]) & 0x900 or g[2] == "*":
            continue
        m = mine.get(g[0][:-2] if g[0].endswith("/1") else g[0])
        if (m is None or int(m[1]) & ~PE_BITS != int(g[1]) & ~PE_BITS
                or m[2:4] + m[5:6] + m[9:] != g[2:4] + g[5:6] + g[9:]):
            bad.append(g[0])
        n_checked += 1
    return n_checked, bad


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op CPU thread pool at ``n`` threads for the body. The
    plain versions issue many small ops; under pytest-xdist every worker
    has its own pool, and pools as wide as the host oversubscribe it (the
    whole suite ran ~6x slower with 6 workers on an 8-core host)."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
