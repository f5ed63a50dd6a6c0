"""The one read generator: a traffic mix (``traffic/<mix>.json``) says what
to draw, this module draws it from the run's seed.

A mix names its length model (``"length"``: a log-normal of a median and
a sigma, cut to ``min`` and ``max``), the sample's own variants against
the reference (``"sample"``: an SNV rate, applied once to a donor copy of
the genome), the sequencing errors (``"errors"``: substitution,
insertion and deletion rates per base), the share of reverse-complemented
reads, the reads a second of the window (``window_reads_per_s``) and the
reads over the device envelope that the check samples (``check_reads``).
Reads never span an N or a chromosome end.

Streams of one seed are independent: the warm reads, the window's reads
and the sample drawn for the check each have their own generator, so the
window's reads are the same whatever the warm call did.

Sizes do not depend on the seed, only their order does, so that every
seed asks for the same work: n reads take the n stratified quantiles of
the length model, shuffled.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

ACGT = np.frombuffer(b"ACGTN", np.uint8)
NAME_DIGITS = 9


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def _donor(seqs: list, sample: dict, g: np.random.Generator) -> np.ndarray:
    """The sample's genome: the reference's chromosomes with SNVs applied,
    joined with one N between chromosomes."""
    parts = []
    for _, codes in seqs:
        c = np.array(codes, np.uint8)
        pos = np.flatnonzero(g.random(len(c)) < sample.get("snv", 0.0))
        pos = pos[c[pos] < 4]
        c[pos] = (c[pos] + g.integers(1, 4, len(pos))) % 4
        parts.append(c)
        parts.append(np.full(1, 4, np.uint8))
    return np.concatenate(parts)


def _revcomp(r: np.ndarray) -> np.ndarray:
    return np.where(r < 4, 3 - r[..., ::-1], r[..., ::-1]).astype(np.uint8)


class Traffic:
    """Reads of one mix over one genome, for one seed."""

    def __init__(self, mix: dict, seqs: list, seed: int):
        self.mix = mix
        self.seed = seed
        self.donor = _donor(seqs, mix.get("sample", {}), rng(seed, 1))
        self.n_at = np.flatnonzero(self.donor > 3)

    def _starts(self, lens, g):
        """Start positions in the donor whose windows of ``lens`` hold no N."""
        st = np.zeros(len(lens), np.int64)
        todo = np.arange(len(lens))
        while len(todo):
            s = g.integers(0, len(self.donor) - lens[todo])
            nxt = np.searchsorted(self.n_at, s)  # the first N at or after s
            ok = (nxt == len(self.n_at)) | (
                self.n_at[np.minimum(nxt, len(self.n_at) - 1)] >= s + lens[todo])
            st[todo[ok]] = s[ok]
            todo = todo[~ok]
        return st

    def _lengths(self, n, g):
        """The n stratified quantiles of the truncated log-normal, in an
        order drawn from ``g``."""
        ln = self.mix["length"]
        nd = NormalDist()
        lo, hi = (nd.cdf(np.log(ln[b] / ln["median"]) / ln["sigma"]) for b in ("min", "max"))
        u = lo + (hi - lo) * (np.arange(n) + 0.5) / n
        x = [ln["median"] * np.exp(ln["sigma"] * nd.inv_cdf(v)) for v in u]
        return g.permutation(np.clip(np.round(x), ln["min"], ln["max"]).astype(np.int64))

    def reads(self, n: int, stream: int, max_len: int | None = None) -> list:
        """The n reads of the length model, each a uint8 code array; with
        ``max_len``, only those of at most ``max_len`` bases and the
        shortest longer one."""
        g = rng(self.seed, stream)
        err = self.mix.get("errors", {})
        lens = self._lengths(n, g)
        if max_len is not None:
            over = np.flatnonzero(lens > max_len)
            keep = lens <= max_len
            if len(over):
                keep[over[np.argmin(lens[over])]] = True
            lens = lens[keep]
        out = []
        for s, ln in zip(self._starts(lens, g), lens):
            r = self.donor[s: s + ln].copy()
            sub = g.random(len(r)) < err.get("sub", 0.0)
            r[sub] = (r[sub] + g.integers(1, 4, int(sub.sum()))) % 4
            r = r[g.random(len(r)) >= err.get("del", 0.0)]
            ins = np.flatnonzero(g.random(len(r)) < err.get("ins", 0.0))
            r = np.insert(r, ins, g.integers(0, 4, len(ins)).astype(np.uint8))
            if g.random() < self.mix.get("revcomp", 0.5):
                r = _revcomp(r)
            out.append(r)
        return out


def name(i: int) -> str:
    return f"r{i:0{NAME_DIGITS}d}"


def fastq(reads, first: int = 0) -> bytes:
    """FASTQ text of ``reads`` (a list of code arrays), named r<9 digits>
    from ``first`` on, every quality 'I'."""
    parts = []
    for i, r in enumerate(reads):
        s = ACGT[r].tobytes()
        parts.append(b"@%s\n%s\n+\n%s\n" % (name(first + i).encode(), s, b"I" * len(r)))
    return b"".join(parts)


def seq(r: np.ndarray) -> str:
    return ACGT[r].tobytes().decode()
