"""File-level mapping driver of the port (the mm_map_file analog).

Port of ``gdiet_tpu/runtime.py``. ``run_mapping`` routes a run exactly as
``gdiet_tpu`` does (``runtime.py:463-514``):

- ``--split-prefix`` with a FASTA target larger than ``-I``:
  ``run_split_mapping``, one index part at a time through ``map_batch``,
  then the parts' regs merged and re-ranked (``runtime.py:80-189``);
- short reads, single-end, plain SAM (``run_sr_sam``): fixed-shape batches
  through ``ShortReadMapper.map_stream_sam`` with one-batch lookahead,
  budgets scaled to the observed read length, and an adaptive re-tier to
  a wider Lmax when long reads keep arriving;
- short reads, paired-end, plain SAM (``run_sr_pe_sam``): pairs from two
  FASTQs through ``map_stream_sam_pe``;
- everything else (``run_generic``, the per-record writer of
  ``runtime.py:516-674``): long reads, PAF (``-c``, ``--paf-no-hit``),
  ``-y/--MD/--cs``, ``-T``, ``--print-seeds``, ``--split-reads``,
  ``GDIET_NO_PE_FAST``, ``pe_ori < 0``, no CIGAR, more than one short-read
  query file: fragment batches of ``mini_batch_size`` bases through
  ``map_stream``, one record per region.

``--mesh DATAxREF`` maps the short-read paths and the long-read path over a
(data, ref) mesh (``parallel/dist.py``): a virtual mesh of the CPU with
``--device cpu``, DATA x REF cards with ``--device cuda``; the paired-end
fast path stays off under a mesh, as in ``gdiet_tpu``. With
``GDIET_COORDINATOR`` (host:port), ``GDIET_NUM_PROCESSES`` and
``GDIET_PROCESS_ID`` set, the process first joins a gloo process group
(each process maps its own reads) and leaves it when the run ends. ``-v 4``
adds the five-stage profile of the single-end SAM path, and keeps the
spans of ``utils/profile.py::PROFILE`` as intervals (as a collecting
``torch.profiler`` does): ``run_generic`` is the root span ``run``, with
``run.mapper_init``, ``run.read`` (FASTQ parsing and staging) and
``run.write`` (records out) beside the mapper's spans; the report prints
each span's total, self time and count, and the mapper's counters.

``run_generic`` maps with the objects alive when its mapping starts (the
index, its tables, the mapper, the modules) frozen out of the cyclic
collector (``gc.freeze``): with a 300 Mbp index on an H100 host, a full
collection over them took ~100 ms, once in ~3 calls of 60 ONT reads, a
third of such a call's time.
"""

from __future__ import annotations

import gc
import os
import resource
import sys
import time

import torch

from gdiet_tpu_torch import __version__, config as cfg, debug
from gdiet_tpu_torch.index.build import TorchIndex, build_index
from gdiet_tpu_torch.io import sam as samio
from gdiet_tpu_torch.io.fastx import (SeqRecord, read_fastx, read_frag_batches,
                                      split_ultralong)
from gdiet_tpu_torch.utils.profile import PROFILE, Stage


def _log(verbose: int, t0: float, msg: str) -> None:
    if verbose >= 3:
        print(f"[M::gdiet::{time.perf_counter() - t0:.3f}*"
              f"{time.process_time():.2f}] {msg}", file=sys.stderr)


def load_or_build_index(target: str, io, device, verbose: int = 3,
                        t0: float | None = None) -> TorchIndex:
    """A gdiet npz index, or an index built from FASTA on ``device``."""
    t0 = time.perf_counter() if t0 is None else t0
    if TorchIndex.is_index(target):
        mi = TorchIndex.load(target, device)
        _log(verbose, t0, f"loaded prebuilt index ({mi.n_seq} sequences)")
        if (mi.k != io.k or mi.w != io.w) and verbose >= 2:
            print("[WARNING] Indexing parameters k/w differ from the CLI "
                  "setting; using the index's", file=sys.stderr)
        return mi
    with PROFILE.stage(Stage.INDEXING):
        mi = build_index(((r.name, r.seq) for r in read_fastx(target)),
                         io, device)
    _log(verbose, t0, f"built the index for {mi.n_seq} target sequence(s)")
    if verbose >= 3:  # mm_idx_stat (index.c:102-127)
        st = mi.stats()
        print(f"[M::mm_idx_stat] kmer size: {st['kmer_size']}; skip: "
              f"{st['skip']}; #seq: {st['n_seq']}; distinct minimizers: "
              f"{st['distinct_minimizers']} ({st['pct_singletons']:.2f}% are "
              f"singletons); average occurrences: {st['avg_occurrences']:.3f}; "
              f"average spacing: {st['avg_spacing']:.3f}", file=sys.stderr)
    return mi


def _open_sam(out_path: str | None, mi, cli_line: str):
    """The SAM output stream with its header written."""
    bout = (open(out_path, "wb") if out_path and out_path != "-"
            else sys.stdout.buffer)
    bout.write(samio.sam_header(mi.names, [int(x) for x in mi.lengths],
                                    cli_line, __version__).encode())
    return bout


def _close_and_report(bout, n_mapped: int, verbose: int, cli_line: str,
                      t0: float) -> None:
    if bout is not sys.stdout.buffer:
        bout.close()
    _log(verbose, t0, f"mapped {n_mapped} sequences")
    _report(verbose, cli_line, t0)


def _report(verbose: int, cli_line: str, t0: float, counters: dict | None = None) -> None:
    """The run's summary at ``-v 3``; ``-v 4`` adds ``counters`` (the
    mapper's stats)."""
    if verbose >= 3:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"[M::gdiet] Version: {__version__}", file=sys.stderr)
        print(f"[M::gdiet] CMD: {cli_line}", file=sys.stderr)
        print(f"[M::gdiet] Real time: {time.perf_counter() - t0:.3f} sec; "
              f"CPU: {time.process_time():.3f} sec; Peak RSS: {rss:.3f} GB",
              file=sys.stderr)
        PROFILE.report(sys.stderr, counters if verbose >= 4 else None)


def run_sr_sam(mi, mo, query: str, out_path: str | None, n_threads: int,
               verbose: int, cli_line: str, t0: float, device,
               batch_reads: int = 8192, mesh=None) -> int:
    """SR + SAM path (gdiet_tpu/runtime.py:192-335): fixed batch shape,
    tail batch padded, Lmax from the first batch, re-tier after enough
    length-overflow reads. ``mesh``: ``ShortReadMapper``'s; ``verbose >=
    4`` adds the five-stage profile."""
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    rdr = read_fastx(query)
    first = []
    for rec in rdr:
        first.append(rec)
        if len(first) >= batch_reads:
            break
    bout = _open_sam(out_path, mi, cli_line)
    n_mapped = 0
    if first:
        B = 1
        while B < len(first):
            B <<= 1
        B = min(B, batch_reads)
        HARD_CAP = 304  # reads beyond this always take the oracle

        def _round16(n: int) -> int:
            return min(HARD_CAP, -(-max(n, 64) // 16) * 16)

        def make_mapper(lmax: int) -> ShortReadMapper:
            scale = -(-lmax // 160)  # bench budgets are tuned at Lmax=160
            return ShortReadMapper(
                mi, mo, max_read_len=lmax, seed_budget=32 * scale,
                shift_seed_budget=16 * scale, hit_budget=64 * scale,
                dp_frac=0.3125, n_threads=n_threads, device=device,
                mesh=mesh, profile_stages=verbose >= 4)

        Lmax = _round16(max(r.l_seq for r in first))
        mapper = make_mapper(Lmax)
        counter = [0]
        tier = {"over": 0, "max_len": 0, "hit": False}
        retier_at = max(32, B // 64)
        pending: list = []

        def raw_batches():
            buf = first
            for rec in rdr:
                if len(buf) == B:
                    yield buf
                    buf = []
                buf.append(rec)
            if len(buf) == B:
                yield buf
            elif buf:
                yield (buf + [buf[0]] * (B - len(buf)), len(buf))

        src = raw_batches()

        def gated():
            """Pass batches until the overflow budget trips; then stash the
            triggering batch and end the stream for a wider re-tier."""
            while pending:
                b = pending.pop(0)
                counter[0] += b[1] if isinstance(b, tuple) else len(b)
                yield b
            for b in src:
                batch, n = b if isinstance(b, tuple) else (b, len(b))
                if Lmax < HARD_CAP:
                    cap = min(300, Lmax)
                    longs = [r.l_seq for r in batch[:n] if cap < r.l_seq <= HARD_CAP]
                    if longs:
                        tier["over"] += len(longs)
                        tier["max_len"] = max(tier["max_len"], max(longs))
                        if tier["over"] >= retier_at:
                            pending.append(b)
                            tier["hit"] = True
                            return
                counter[0] += n
                yield b

        while True:
            tier["hit"] = False
            for blob in mapper.map_stream_sam(gated()):
                bout.write(blob)
            if not tier["hit"]:
                break
            new_lmax = _round16(tier["max_len"])
            _log(verbose, t0, f"re-tier: Lmax {Lmax} -> {new_lmax} after "
                 f"{tier['over']} length-overflow reads")
            Lmax = new_lmax
            tier["over"], tier["max_len"] = 0, 0
            mapper = make_mapper(Lmax)
        n_mapped = counter[0]
    _close_and_report(bout, n_mapped, verbose, cli_line, t0)
    return 0


def run_sr_pe_sam(mi, mo, q1: str, q2: str, out_path: str | None,
                  n_threads: int, verbose: int, cli_line: str, t0: float,
                  device, batch_pairs: int = 4096) -> int:
    """Paired-end SR + SAM path (gdiet_tpu/runtime.py:338-430): both ends
    of each pair map as fused-step rows; pairing and the mate-field records
    run in the native ``pe_finish_batch``. Fixed batch of P pairs (the next
    power of two up to ``batch_pairs``), tail padded; trailing records
    without a mate map single-end through the oracle."""
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    it1, it2 = read_fastx(q1), read_fastx(q2)
    first: list = []
    odd: list = []  # unpaired leftovers (file length mismatch)
    for r1 in it1:
        r2 = next(it2, None)
        if r2 is None:
            odd.append(r1)
            break
        first.append((r1, r2))
        if len(first) >= batch_pairs:
            break
    bout = _open_sam(out_path, mi, cli_line)
    n_mapped = 0
    if first:
        P = 1
        while P < len(first):
            P <<= 1
        P = min(P, batch_pairs)
        L0 = max(max(a.l_seq, b.l_seq) for a, b in first)
        Lmax = min(304, -(-max(L0, 64) // 16) * 16)
        scale = -(-Lmax // 160)  # bench budgets are tuned at Lmax=160
        mapper = ShortReadMapper(
            mi, mo, max_read_len=Lmax, seed_budget=32 * scale,
            shift_seed_budget=16 * scale, hit_budget=64 * scale,
            dp_frac=0.3125, n_threads=n_threads, device=device)
        counter = [0]

        def batches():
            buf = first
            for r1 in it1:
                r2 = next(it2, None)
                if r2 is None:
                    odd.append(r1)
                    break
                if len(buf) == P:
                    counter[0] += 2 * len(buf)
                    yield buf
                    buf = []
                buf.append((r1, r2))
            counter[0] += 2 * len(buf)
            if len(buf) == P:
                yield buf
            elif buf:
                yield (buf + [buf[0]] * (P - len(buf)), len(buf))

        for blob in mapper.map_stream_sam_pe(batches()):
            bout.write(blob)
        n_mapped = counter[0]
        for rec in [*odd, *it2]:  # trailing unpaired records map single-end
            bout.write(mapper._oracle_sam(rec, 0))
            n_mapped += 1
    _close_and_report(bout, n_mapped, verbose, cli_line, t0)
    return 0


def _make_mapper(mi, mo, variant: str, max_read_len: int | None, device,
                 n_threads: int = 1, mesh=None):
    if variant == "sr":
        from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

        return ShortReadMapper(mi, mo, max_read_len=max_read_len or 256,
                               n_threads=n_threads, device=device, mesh=mesh)
    from gdiet_tpu_torch.pipeline.longread import LongReadMapper

    return LongReadMapper(mi, mo, n_threads=n_threads, device=device, mesh=mesh)


def _out_stream(out_path: str | None):
    return open(out_path, "w") if out_path and out_path != "-" else sys.stdout


def run_split_mapping(io, mo, variant: str, target: str, queries: list, out,
                      verbose: int, cli_line: str, max_read_len: int | None,
                      t0: float, device) -> int:
    """Multi-part index mapping with the --split-prefix merge re-ranking
    (gdiet_tpu/runtime.py:80-189: map.c:1094-1163 merge_hits + splitidx.c,
    in memory instead of temp files): each part built on ``device`` maps
    every read through ``map_batch``; per read, the parts' regs are merged,
    re-ranked with the hit.c/pe.c stack and written as SAM or PAF."""
    from gdiet_tpu_torch.index.build import build_index_parts
    from gdiet_tpu_torch.oracle import hit as ohit

    with PROFILE.stage(Stage.INDEXING):
        refs = [(r.name, r.seq) for r in read_fastx(target)]
        parts = list(build_index_parts(refs, io, device))
    _log(verbose, t0, f"built {len(parts)} index part(s)")

    group = queries if len(queries) == 2 else queries[:1]
    frags = []
    for fb in read_frag_batches(group, 1 << 62):
        frags.extend(fb)
    flat = [rec for frag in frags for rec in frag]
    per_seg_regs: list = [[] for _ in flat]
    for mi_part, rid_shift in parts:
        mapper = _make_mapper(mi_part, mo, variant, max_read_len, device)
        for segi, regs in enumerate(mapper.map_batch(flat)):
            for r in regs or []:
                r.rid += rid_shift
                per_seg_regs[segi].append(r)
    names: list = []
    lens: list = []
    for mi_part, _ in parts:
        names.extend(mi_part.names)
        lens.extend(int(x) for x in mi_part.lengths)

    # merge re-rank per segment (merge_hits)
    for segi, regs in enumerate(per_seg_regs):
        rec = flat[segi]
        if not regs:
            continue
        if not (mo.flag & cfg.MM_F_SR) and rec.l_seq >= mo.rank_min_len:
            ohit.update_dp_max(rec.l_seq, regs, mo.rank_frac, mo.a, mo.b)
        for r in regs:
            r.dp_max2 = 0
            r.subsc = 0
            r.n_sub = 0
        regs = ohit.hit_sort(regs)
        ohit.set_parent(regs, mo.mask_level, mo.mask_len, mo.a * 2 + mo.b)
        if not (mo.flag & cfg.MM_F_ALL_CHAINS):
            regs = ohit.select_sub(regs, mo.pri_ratio, 2 * io.k, mo.best_n)
            ohit.set_sam_pri(regs)
        ohit.set_mapq(regs, mo.min_chain_score, mo.a, 0, bool(mo.flag & cfg.MM_F_SR))
        per_seg_regs[segi] = regs
    # paired: proper-pair flags + PE mapq blend (map.c:1157-1159)
    segi = 0
    for frag in frags:
        if len(frag) == 2 and mo.pe_ori >= 0 and (mo.flag & cfg.MM_F_CIGAR):
            ohit.pair(0, mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                      [frag[0].l_seq, frag[1].l_seq],
                      [per_seg_regs[segi], per_seg_regs[segi + 1]])
        segi += len(frag)

    sam_mode = bool(mo.flag & cfg.MM_F_OUT_SAM)
    if sam_mode:
        out.write(samio.sam_header(names, lens, cli_line, __version__))
    segi = 0
    n_out = 0
    for frag in frags:
        n = len(frag)
        for j, rec in enumerate(frag):
            regs = per_seg_regs[segi + j]
            mate = per_seg_regs[segi + (j + 1) % n] if n > 1 else None
            if regs:
                for r in regs:
                    if (mo.flag & cfg.MM_F_NO_PRINT_2ND) and r.id != r.parent:
                        continue
                    if sam_mode:
                        out.write(samio.sam_record(
                            rec.name, rec.seq, rec.qual, r, regs, names,
                            mo.flag, 0, j, n, mate, comment=rec.comment) + "\n")
                    else:
                        out.write(samio.paf_record(
                            rec.name, rec.l_seq, r, names, lens, 0,
                            bool(mo.flag & cfg.MM_F_OUT_CG), mo.flag,
                            rec.comment) + "\n")
            elif sam_mode:
                out.write(samio.sam_record(
                    rec.name, rec.seq, rec.qual, None, [], names, mo.flag,
                    0, j, n, mate, comment=rec.comment) + "\n")
            n_out += 1
        segi += n
    _log(verbose, t0, f"mapped {n_out} sequences across {len(parts)} parts")
    return 0


def run_generic(mi, mo, variant: str, queries: list, out_path: str | None,
                n_threads: int, verbose: int, cli_line: str, t0: float, device,
                max_read_len: int | None = None, mesh=None) -> int:
    """The per-record writer (gdiet_tpu/runtime.py:516-674): fragment
    batches of ``mini_batch_size`` bases (``--split-reads`` cuts long reads
    into chunks first) through ``map_stream``, one SAM or PAF record per
    region. With two query files (or consecutive records sharing a qname)
    the segments of a fragment are revcomp'd per ``pe_ori``, paired
    (mm_pair) on their mapping-orientation regs, flipped back and written
    with mate fields."""
    with PROFILE.span("run"):
        with PROFILE.span("run.mapper_init"):
            mapper = _make_mapper(mi, mo, variant, max_read_len, device, n_threads, mesh)
        gc.freeze()
        try:
            _map_and_write(mapper, mi, mo, queries, out_path, verbose, cli_line, t0)
        finally:
            gc.unfreeze()
    _report(verbose, cli_line, t0, mapper.stats)
    return 0


def _map_and_write(mapper, mi, mo, queries: list, out_path: str | None,
                   verbose: int, cli_line: str, t0: float) -> None:
    """``run_generic``'s batches through ``mapper.map_stream``, written."""
    from gdiet_tpu_torch.oracle import hit as ohit

    out = _out_stream(out_path)
    sam_mode = bool(mo.flag & cfg.MM_F_OUT_SAM)
    if sam_mode:
        out.write(samio.sam_header(mi.names, [int(x) for x in mi.lengths],
                                   cli_line, __version__))
    names = mi.names
    lens = [int(x) for x in mi.lengths]
    n_mapped = 0

    # a batch's records go out in one write (as mm_map_file's worker
    # writes its batch's kstring)
    lines: list = []

    def write(rec, r, regs, seg_idx=0, n_seg=1, mate_regs=None):
        if sam_mode:
            lines.append(samio.sam_record(
                rec.name, rec.seq, rec.qual, r, regs or [], names, mo.flag,
                0, seg_idx, n_seg, mate_regs, index=mi,
                comment=rec.comment) + "\n")
        elif r is not None:
            lines.append(samio.paf_record(
                rec.name, rec.l_seq, r, names, lens, 0,
                bool(mo.flag & cfg.MM_F_OUT_CG), mo.flag, rec.comment) + "\n")
        elif mo.flag & cfg.MM_F_PAF_NO_HIT:
            lines.append(samio.paf_record(rec.name, rec.l_seq, None, names, lens,
                                          0, False, mo.flag, rec.comment) + "\n")

    def emit_frags(frags, results):
        """Per-fragment output with mate fields (map.c:1208-1280)."""
        nonlocal n_mapped
        k = 0
        for frag in frags:
            n = len(frag)
            frag_res = results[k : k + n]
            k += n
            for j, rec in enumerate(frag):
                n_mapped += 1
                regs = frag_res[j]
                mate = frag_res[(j + 1) % n] if n > 1 else None
                if regs:
                    for r in regs:
                        if (mo.flag & cfg.MM_F_NO_PRINT_2ND) and r.id != r.parent:
                            continue
                        write(rec, r, regs, j, n, mate)
                else:
                    write(rec, None, [], j, n, mate)

    query_groups = [queries] if len(queries) == 2 else [[q] for q in queries]
    for group in query_groups:
        with PROFILE.span("run.read"):
            frag_batches, flat_batches, flips = _stage_batches(group, mo)
        for fb, flat, flip, results in zip(frag_batches, flat_batches, flips,
                                           mapper.map_stream(flat_batches)):
            if mo.pe_ori >= 0 and (mo.flag & cfg.MM_F_CIGAR):
                # mm_pair on mapping-orientation regs; the reference never
                # computes frag_gap, so pairs are bounded by the frag-mode
                # fragment budget (gdiet_tpu/runtime.py:636-653)
                gap = (mo.max_gap_ref if mo.max_gap_ref >= 0
                       else max(mo.max_gap, mo.max_frag_len or 800))
                kk = 0
                for frag in fb:
                    if (len(frag) == 2 and results[kk] is not None
                            and results[kk + 1] is not None):
                        ohit.pair(gap, mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                                  [flat[kk].l_seq, flat[kk + 1].l_seq],
                                  [results[kk], results[kk + 1]])
                    kk += len(frag)
            for idx in flip:  # back to the original read strand
                qlen = flat[idx].l_seq
                for r in results[idx] or []:
                    r.qs, r.qe = qlen - r.qe, qlen - r.qs
                    r.rev = 0 if r.rev else 1
            with PROFILE.span("run.write"):
                emit_frags(fb, results)
                out.write("".join(lines))
                lines.clear()
        _log(verbose, t0, f"mapped {n_mapped} sequences")
    if out is not sys.stdout:
        with PROFILE.span("run.write"):
            out.close()


def _stage_batches(group: list, mo):
    """(frag_batches, flat_batches, flips) of one query group: fragment
    batches of ``mini_batch_size`` bases (``--split-reads`` cuts long reads
    into chunks first), flattened, with paired segments revcomp'd per
    ``pe_ori`` before mapping (worker_for, map.c:1057-1090); ``flips``
    lists them, so their coordinates flip back after."""
    frag_batches = list(read_frag_batches(group, mo.mini_batch_size))
    if mo.split_len > 0:  # --split-reads (ultralong ONT chunking)
        frag_batches = [
            [[c] for frag in fb for rec in frag
             for c in split_ultralong([rec], mo.split_len)]
            for fb in frag_batches]
    flat_batches, flips = [], []
    for fb in frag_batches:
        flat, flip = [], []
        for frag in fb:
            for j, rec in enumerate(frag):
                if len(frag) == 2 and ((j == 0 and (mo.pe_ori >> 1) & 1)
                                       or (j == 1 and mo.pe_ori & 1)):
                    flat.append(SeqRecord(
                        rec.name, samio.revcomp(rec.seq),
                        rec.qual[::-1] if rec.qual else None, rec.comment))
                    flip.append(len(flat) - 1)
                else:
                    flat.append(rec)
        flat_batches.append(flat)
        flips.append(flip)
    return frag_batches, flat_batches, flips


# flags that only the per-record writer honours
GENERIC_FLAGS = (cfg.MM_F_COPY_COMMENT | cfg.MM_F_OUT_MD | cfg.MM_F_OUT_CS
                 | cfg.MM_F_OUT_CS_LONG | cfg.MM_F_OUT_CG)


def route(mo, variant: str, queries: list, max_read_len: int | None = None) -> str:
    """Which writer a run takes, under gdiet_tpu/runtime.py:493-514's
    conditions: "sr_se" (``run_sr_sam``), "sr_pe" (``run_sr_pe_sam``) or
    "generic" (``run_generic``)."""
    fast = (variant == "sr" and bool(mo.flag & cfg.MM_F_OUT_SAM)
            and mo.split_len <= 0 and not (mo.flag & GENERIC_FLAGS)
            and not debug.enabled() and mo.sdust_thres <= 0
            and max_read_len is None)
    if fast and len(queries) == 1:
        return "sr_se"
    if (fast and len(queries) == 2 and not os.environ.get("GDIET_NO_PE_FAST")
            and mo.pe_ori >= 0 and (mo.flag & cfg.MM_F_CIGAR)
            and mo.mesh_shape is None):
        return "sr_pe"
    return "generic"


def _mesh(mo, device, verbose: int, t0: float):
    """The ``--mesh`` mesh of a run, logged as gdiet_tpu/runtime.py:217-223
    logs it; None without ``--mesh``."""
    if mo.mesh_shape is None:
        return None
    from gdiet_tpu_torch.parallel.dist import device_mesh

    mesh = device_mesh(mo.mesh_shape, device)
    _log(verbose, t0, f"multi-chip mesh: data={mo.mesh_shape[0]} ref={mo.mesh_shape[1]}")
    return mesh


def run_mapping(io, mo, variant: str, target: str, queries: list,
                device, fnw: str | None = None, out_path: str | None = None,
                n_threads: int = 3, verbose: int = 3,
                cli_line: str = "gdiet", max_read_len: int | None = None) -> int:
    """Build or load the index on ``device``, then map through the writer
    ``route`` picks (``--split-prefix`` first, as gdiet_tpu/runtime.py:432-674
    does). With ``GDIET_COORDINATOR`` set the run is one process of a
    group (gdiet_tpu/runtime.py:447-460): it joins first and leaves at the
    end, after every process finished when the run succeeded."""
    t0 = time.perf_counter()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[ERROR] --device cuda: no CUDA device is available")
    coordinator = os.environ.get("GDIET_COORDINATOR")
    # -v 4 keeps the run's spans as intervals for the report
    traced, PROFILE.enabled = PROFILE.enabled, PROFILE.enabled or verbose >= 4
    try:
        if not coordinator:
            return _run_mapping(io, mo, variant, target, queries, device, fnw, out_path,
                                n_threads, verbose, cli_line, max_read_len, t0)
        from gdiet_tpu_torch.parallel.dist import init_distributed, shutdown_distributed

        pid = int(os.environ.get("GDIET_PROCESS_ID", "0"))
        world = init_distributed(coordinator,
                                 int(os.environ.get("GDIET_NUM_PROCESSES", "1")), pid)
        _log(verbose, t0, f"joined torch.distributed (gloo) as process {pid} of {world}")
        done = False
        try:
            rc = _run_mapping(io, mo, variant, target, queries, device, fnw, out_path,
                              n_threads, verbose, cli_line, max_read_len, t0)
            done = True
            return rc
        finally:
            shutdown_distributed(wait=done)
    finally:
        PROFILE.enabled = traced


def _run_mapping(io, mo, variant: str, target: str, queries: list, device, fnw,
                 out_path, n_threads: int, verbose: int, cli_line: str,
                 max_read_len, t0: float) -> int:
    # multi-part split mapping (-I small + --split-prefix)
    if mo.split_prefix and not TorchIndex.is_index(target):
        total = sum(r.l_seq for r in read_fastx(target))
        if total > io.batch_size:
            out = _out_stream(out_path)
            try:
                return run_split_mapping(io, mo, variant, target, queries, out,
                                         verbose, cli_line, max_read_len, t0,
                                         device)
            finally:
                if out is not sys.stdout:
                    out.close()

    mi = load_or_build_index(target, io, device, verbose, t0)
    if fnw:
        mi.save(fnw)
        _log(verbose, t0, f"dumped the index to {fnw}")
        if not queries:
            return 0
    path = route(mo, variant, queries, max_read_len)
    if path == "sr_se":
        return run_sr_sam(mi, mo, queries[0], out_path, n_threads, verbose,
                          cli_line, t0, device, mesh=_mesh(mo, device, verbose, t0))
    if path == "sr_pe":
        return run_sr_pe_sam(mi, mo, queries[0], queries[1], out_path,
                             n_threads, verbose, cli_line, t0, device)
    return run_generic(mi, mo, variant, queries, out_path, n_threads, verbose,
                       cli_line, t0, device, max_read_len,
                       mesh=_mesh(mo, device, verbose, t0))
