"""FASTA/FASTQ reading (gzip-transparent) with base-count batching.

Replaces the reference's kseq/bseq layer (GDiet-ShortReads/bseq.c:80-163):
reads are accumulated into mini-batches by total base count
(mini_batch_size) so downstream device batches have bounded footprint.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SeqRecord:
    name: str
    seq: str
    qual: str | None = None
    comment: str | None = None

    @property
    def l_seq(self) -> int:
        return len(self.seq)


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rt")
    import io as _io

    return _io.TextIOWrapper(f)


def read_fastx(path: str) -> Iterator[SeqRecord]:
    """Yield records from a FASTA or FASTQ file (optionally gzipped)."""
    with _open(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == ">":
            name = comment = None
            parts: list[str] = []
            line = f.readline()
            hdr = line.rstrip("\n")
            name, _, comment = hdr.partition(" ")
            comment = comment or None
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    yield SeqRecord(name, "".join(parts), None, comment)
                    hdr = line[1:]
                    name, _, comment = hdr.partition(" ")
                    comment = comment or None
                    parts = []
                else:
                    parts.append(line)
            yield SeqRecord(name, "".join(parts), None, comment)
        elif first == "@":
            hdr = f.readline().rstrip("\n")
            while True:
                name, _, comment = hdr.partition(" ")
                seq = f.readline().rstrip("\n")
                f.readline()  # +
                qual = f.readline().rstrip("\n")
                yield SeqRecord(name, seq, qual or None, comment or None)
                line = f.readline()
                if not line:
                    return
                hdr = line.rstrip("\n")
                if hdr.startswith("@"):
                    hdr = hdr[1:]
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def read_frag_batches(
    paths: list[str], mini_batch_size: int
) -> Iterator[list[list[SeqRecord]]]:
    """Paired/fragment batching (mm_bseq_read_frag2, bseq.c:131-163):
    with two files, records are interleaved per fragment; with one file,
    consecutive records sharing a qname (after /1 /2 trimming) form one
    fragment. Yields batches of fragments."""
    from gdiet_tpu_torch.io.sam import qname_same

    def frags() -> Iterator[list[SeqRecord]]:
        if len(paths) == 2:
            it1, it2 = read_fastx(paths[0]), read_fastx(paths[1])
            for r1 in it1:
                r2 = next(it2, None)
                yield [r1] if r2 is None else [r1, r2]
        else:
            pend: list[SeqRecord] = []
            for rec in read_fastx(paths[0]):
                if pend and not qname_same(pend[-1].name, rec.name):
                    yield pend
                    pend = []
                pend.append(rec)
            if pend:
                yield pend

    batch: list[list[SeqRecord]] = []
    total = 0
    for fr in frags():
        batch.append(fr)
        total += sum(r.l_seq for r in fr)
        if total >= mini_batch_size:
            yield batch
            batch, total = [], 0
    if batch:
        yield batch


def read_batches(path: str, mini_batch_size: int) -> Iterator[list[SeqRecord]]:
    """Group records into batches of ~mini_batch_size total bases
    (bseq.c mm_bseq_read3 semantics: stop after the batch exceeds it)."""
    batch: list[SeqRecord] = []
    total = 0
    for rec in read_fastx(path):
        batch.append(rec)
        total += rec.l_seq
        if total >= mini_batch_size:
            yield batch
            batch, total = [], 0
    if batch:
        yield batch


def split_ultralong(records, max_len: int):
    """UltraLongReadSplitter.py semantics (Read-mapping-real-data-ONT.sh:16):
    reads longer than ``max_len`` are cut into non-overlapping ``max_len``
    chunks named ``{name}{i} {comment}`` (with a comment) or ``{name}_{i}``
    (without); shorter reads pass through (comment variant gets a "1"
    appended — the splitter's quirk, replicated)."""
    for rec in records:
        if rec.l_seq <= max_len:
            if rec.comment:
                yield SeqRecord(rec.name + "1", rec.seq, rec.qual, rec.comment)
            else:
                yield rec
            continue
        n = (rec.l_seq + max_len - 1) // max_len
        for i in range(n):
            seq = rec.seq[i * max_len : (i + 1) * max_len]
            qual = rec.qual[i * max_len : (i + 1) * max_len] if rec.qual else None
            name = (f"{rec.name}{i}" if rec.comment else f"{rec.name}_{i}")
            yield SeqRecord(name, seq, qual, rec.comment)
