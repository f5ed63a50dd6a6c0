"""The benchmark's genomes, made from the run's seed in NumPy.

``synth_genome`` is a copy of ``eval/scale_rehearsal.py::synth_genome``: a
uniform random sequence with human-like repeats laid over it (LINE-like and
SINE-like families at 5-20% divergence, alpha-satellite-like tandem arrays,
segmental duplications) and N gaps. ``chromosomes`` cuts it into GRCh38's
24 chromosomes, each scaled to the configuration's ``genome_mbp``.
"""

from __future__ import annotations

import numpy as np


def synth_genome(n_bases: int, seed: int):
    """Repeat-rich synthetic genome. Returns (codes, repeat_mask)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n_bases, dtype=np.int8)
    is_rep = np.zeros(n_bases, bool)

    # LINE-like element: 6 kb consensus, ~1200 dispersed copies/100Mbp at
    # 5-15% divergence, many 5'-truncated (like L1)
    line = rng.integers(0, 4, 6000, dtype=np.int8)
    n_lines = int(n_bases / 1e8 * 1200)
    for _ in range(n_lines):
        div = rng.uniform(0.05, 0.15)
        ln = int(rng.integers(500, 6000))
        copy = line[-ln:].copy()
        nmut = rng.binomial(ln, div)
        idx = rng.integers(0, ln, nmut)
        copy[idx] = (copy[idx] + rng.integers(1, 4, nmut)) % 4
        st = int(rng.integers(0, n_bases - ln))
        g[st: st + ln] = copy
        is_rep[st: st + ln] = True

    # SINE-like: 300 bp, denser, 10-20% divergence
    sine = rng.integers(0, 4, 300, dtype=np.int8)
    for _ in range(n_lines * 4):
        div = rng.uniform(0.1, 0.2)
        copy = sine.copy()
        nmut = rng.binomial(300, div)
        idx = rng.integers(0, 300, nmut)
        copy[idx] = (copy[idx] + rng.integers(1, 4, nmut)) % 4
        st = int(rng.integers(0, n_bases - 300))
        g[st: st + 300] = copy
        is_rep[st: st + 300] = True

    # alpha-satellite-like tandem arrays: 171 bp monomer, ~50 kb arrays
    mono = rng.integers(0, 4, 171, dtype=np.int8)
    n_arrays = max(2, n_bases // 40_000_000)
    for _ in range(n_arrays):
        arr_len = int(rng.integers(30_000, 60_000))
        reps = arr_len // 171 + 1
        arr = np.tile(mono, reps)[:arr_len].copy()
        nmut = rng.binomial(arr_len, 0.02)
        idx = rng.integers(0, arr_len, nmut)
        arr[idx] = (arr[idx] + rng.integers(1, 4, nmut)) % 4
        st = int(rng.integers(0, n_bases - arr_len))
        g[st: st + arr_len] = arr
        is_rep[st: st + arr_len] = True

    # segmental duplications: copy 100 kb blocks at ~2% divergence
    for _ in range(n_bases // 60_000_000 + 1):
        ln = 100_000
        src = int(rng.integers(0, n_bases - ln))
        dst = int(rng.integers(0, n_bases - ln))
        blk = g[src: src + ln].copy()
        nmut = rng.binomial(ln, 0.02)
        idx = rng.integers(0, ln, nmut)
        blk[idx] = (blk[idx] + rng.integers(1, 4, nmut)) % 4
        g[dst: dst + ln] = blk
        is_rep[dst: dst + ln] = True
        is_rep[src: src + ln] = True

    # N gaps (centromere/telomere-like)
    for _ in range(n_bases // 30_000_000 + 1):
        ln = int(rng.integers(5_000, 50_000))
        st = int(rng.integers(0, n_bases - ln))
        g[st: st + ln] = 4
    return g.astype(np.uint8), is_rep


# GRCh38's primary chromosomes, chr1-22, X, Y (bp; NCBI GCA_000001405.15)
GRCH38 = [248956422, 242193529, 198295559, 190214555, 181538259, 170805979,
          159345973, 145138636, 138394717, 133797422, 135086622, 133275309,
          114364328, 107043718, 101991189, 90338345, 83257441, 80373285,
          58617616, 64444167, 46709983, 50818468, 156040895, 57227415]
GRCH38_NAMES = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]


def chromosomes(codes: np.ndarray) -> list:
    """[(name, codes)]: ``codes`` cut into GRCh38's chromosomes, each
    scaled by the same factor."""
    ends = np.round(np.cumsum(GRCH38) / sum(GRCH38) * len(codes)).astype(np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    return [(n, codes[a:b]) for n, a, b in zip(GRCH38_NAMES, starts, ends)]


def make_genome(cfg: dict, seed: int) -> list:
    """The configuration's reference genome for ``seed``: [(name, codes)]."""
    codes, _ = synth_genome(int(round(cfg["genome_mbp"] * 1_000_000)), seed)
    return chromosomes(codes)
