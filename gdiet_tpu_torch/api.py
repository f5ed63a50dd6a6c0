"""mappy-compatible Python API of the port.

Port of ``gdiet_tpu/api.py`` (the reference's Cython binding,
GDiet-ShortReads/python/mappy.pyx): ``Aligner`` builds or loads an index on
a torch device and maps one read at a time through the short-read or
long-read mapper's ``map_batch``; ``map()`` yields ``Alignment`` objects
with mappy's attribute names (ctg, r_st, r_en, q_st, q_en, strand, mapq,
cigar, cigar_str, is_primary, mlen, blen, NM, cs, MD), ``seq()`` fetches
reference subsequences, ``fastx_read`` iterates (name, seq, qual) tuples.

``device`` (default ``"cuda"``) is the port's own argument: the index and
every fused step live there; without a GPU, ``"cuda"`` raises.

    from gdiet_tpu_torch.api import Aligner
    a = Aligner("ref.fa", preset="sr", device="cuda")
    for hit in a.map(seq, cs=True, MD=True):
        print(hit)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gdiet_tpu_torch.config import CIGAR_STR, options_for
from gdiet_tpu_torch.index.build import TorchIndex, build_index
from gdiet_tpu_torch.io import sam as samio
from gdiet_tpu_torch.io.fastx import SeqRecord, read_fastx


@dataclass
class Alignment:
    """mappy.Alignment analog (python/mappy.pyx:10-107)."""

    ctg: str
    ctg_len: int
    r_st: int
    r_en: int
    strand: int  # +1 / -1
    q_st: int
    q_en: int
    mapq: int
    cigar: list  # [(len, op_code), ...]
    is_primary: bool
    mlen: int
    blen: int
    NM: int
    trans_strand: int = 0
    read_num: int = 1
    cs: str = ""
    MD: str = ""

    @property
    def cigar_str(self) -> str:
        return "".join(f"{l}{CIGAR_STR[op]}" for l, op in self.cigar)

    def __str__(self) -> str:
        fields = [
            str(self.q_st), str(self.q_en), "+" if self.strand > 0 else "-",
            self.ctg, str(self.ctg_len), str(self.r_st), str(self.r_en),
            str(self.mlen), str(self.blen), str(self.mapq),
            "tp:A:P" if self.is_primary else "tp:A:S",
            "cg:Z:" + self.cigar_str,
        ]
        if self.cs:
            fields.append("cs:Z:" + self.cs)
        return "\t".join(fields)


class Aligner:
    """mappy.Aligner analog (python/mappy.pyx:110-180) on ``device``.

    ``Aligner(fn_idx_in, preset=..., k=..., w=..., pattern=...)`` builds an
    index from a FASTA path or loads a prebuilt npz index (saved by either
    package); ``Aligner(seq=...)`` indexes one in-memory sequence
    (mm_idx_str analog, index.c:425-474).
    """

    def __init__(
        self,
        fn_idx_in: str | None = None,
        preset: str | None = None,
        k: int | None = None,
        w: int | None = None,
        pattern: str | None = None,
        variant: str | None = None,
        best_n: int | None = None,
        fn_idx_out: str | None = None,
        seq: str | None = None,
        max_read_len: int = 256,
        device="cuda",
        **opts,
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Aligner(device='cuda'): no CUDA device is available")
        if variant is None:
            variant = "sr" if preset in ("sr", "short") else "lr"
        over = dict(opts)
        if k is not None:
            over["k"] = k
        if w is not None:
            over["w"] = w
        if pattern is not None:
            over["pattern"] = pattern
        if best_n is not None:
            over["best_n"] = best_n
        self._io, self._mo = options_for(preset, variant=variant, **over)
        self._variant = variant
        if seq is not None:
            self.index = build_index([("N/A", seq)], self._io, device)
        elif fn_idx_in is None:
            raise ValueError("either fn_idx_in or seq is required")
        elif TorchIndex.is_index(fn_idx_in):
            self.index = TorchIndex.load(fn_idx_in, device)
        else:
            refs = [(r.name, r.seq) for r in read_fastx(fn_idx_in)]
            self.index = build_index(refs, self._io, device)
        if fn_idx_out:
            self.index.save(fn_idx_out)
        if variant == "sr":
            from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

            self._mapper = ShortReadMapper(self.index, self._mo,
                                           max_read_len=max_read_len, device=device)
        else:
            from gdiet_tpu_torch.pipeline.longread import LongReadMapper

            self._mapper = LongReadMapper(self.index, self._mo, device=device)

    def __bool__(self) -> bool:
        return self.index.n_seq > 0

    # ---- mappy properties -------------------------------------------------
    @property
    def k(self) -> int:
        return self.index.k

    @property
    def w(self) -> int:
        return self.index.w

    @property
    def n_seq(self) -> int:
        return self.index.n_seq

    @property
    def seq_names(self) -> list:
        return list(self.index.names)

    def seq(self, name: str, start: int = 0, end: int = 0x7FFFFFFF) -> str | None:
        """Fetch an uppercase reference subsequence (mappy.Aligner.seq)."""
        if name not in self.index.names:
            return None
        rid = self.index.names.index(name)
        end = min(end, int(self.index.lengths[rid]))
        codes = self.index.getseq(rid, start, end)
        return "".join("ACGTN"[min(c, 4)] for c in codes)

    # ---- mapping ----------------------------------------------------------
    def map(self, seq: str, seq2: str | None = None, cs: bool = False,
            MD: bool = False):
        """Yield Alignments for one read (mappy.Aligner.map). ``seq2`` maps
        the mate independently (read_num 2)."""
        for read_num, s in ((1, seq), (2, seq2)):
            if s is None:
                continue
            regs = self._mapper.map_batch([SeqRecord("q", s)])[0]
            for r in regs or []:
                if not r.cigar:
                    continue
                aln = Alignment(
                    ctg=self.index.names[r.rid],
                    ctg_len=int(self.index.lengths[r.rid]),
                    r_st=r.rs, r_en=r.re,
                    strand=-1 if r.rev else 1,
                    q_st=r.qs, q_en=r.qe,
                    mapq=r.mapq,
                    cigar=[(l, op) for l, op in r.cigar],
                    is_primary=(r.id == r.parent),
                    mlen=r.mlen, blen=r.blen,
                    NM=r.blen - r.mlen + r.n_ambi,
                    read_num=read_num,
                )
                if cs:
                    aln.cs = samio.gen_cs_md(self.index, r, s, False)
                if MD:
                    aln.MD = samio.gen_cs_md(self.index, r, s, True)
                yield aln


def fastx_read(fn: str, read_comment: bool = False):
    """mappy.fastx_read analog: yields (name, seq, qual[, comment])."""
    for rec in read_fastx(fn):
        if read_comment:
            yield rec.name, rec.seq, rec.qual, rec.comment
        else:
            yield rec.name, rec.seq, rec.qual


def revcomp(seq: str) -> str:
    """mappy.revcomp analog."""
    return samio.revcomp(seq)
