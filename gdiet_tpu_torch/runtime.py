"""File-level mapping driver of the port (the mm_map_file analog).

Port of ``gdiet_tpu/runtime.py`` for the SAM paths. Short reads, single-end
(``_run_sr_sam_fast``): fixed-shape batches through
``ShortReadMapper.map_stream_sam`` with one-batch lookahead, budgets scaled
to the observed read length, and an adaptive re-tier to a wider Lmax when
long reads keep arriving. Short reads, paired-end (``_run_sr_pe_sam_fast``):
pairs from two FASTQs through ``map_stream_sam_pe``. Long reads (the
generic per-record path, ``runtime.py:516-674``): fragment batches of
``mini_batch_size`` bases through ``LongReadMapper.map_stream``, one SAM
record per region. PAF, ``--split-prefix``/``--split-reads``, ``--mesh``
and ``-y/--MD/--cs/-c`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import resource
import sys
import time

import torch

from gdiet_tpu_torch import __version__, config as cfg, debug
from gdiet_tpu_torch.index.build import TorchIndex, build_index
from gdiet_tpu_torch.io import sam as samio
from gdiet_tpu_torch.io.fastx import SeqRecord, read_fastx, read_frag_batches
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
        return mi
    with PROFILE.stage(Stage.INDEXING):
        mi = build_index(((r.name, r.seq) for r in read_fastx(target)),
                         io, device)
    _log(verbose, t0, f"built the index for {mi.n_seq} target sequence(s)")
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
    if verbose >= 3:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"[M::gdiet] Version: {__version__}", file=sys.stderr)
        print(f"[M::gdiet] CMD: {cli_line}", file=sys.stderr)
        print(f"[M::gdiet] Real time: {time.perf_counter() - t0:.3f} sec; "
              f"CPU: {time.process_time():.3f} sec; Peak RSS: {rss:.3f} GB",
              file=sys.stderr)
        PROFILE.report(sys.stderr)


def run_sr_sam(mi, mo, query: str, out_path: str | None, n_threads: int,
               verbose: int, cli_line: str, t0: float, device,
               batch_reads: int = 8192, dp_fold: bool = False) -> int:
    """SR + SAM path (gdiet_tpu/runtime.py:192-335): fixed batch shape,
    tail batch padded, Lmax from the first batch, re-tier after enough
    length-overflow reads. ``dp_fold``: ``TorchFusedMapper``'s."""
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
                dp_fold=dp_fold)

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
                  device, batch_pairs: int = 4096, dp_fold: bool = False) -> int:
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
            dp_frac=0.3125, n_threads=n_threads, device=device,
            dp_fold=dp_fold)
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


def run_lr_sam(mi, mo, queries: list, out_path: str | None, n_threads: int,
               verbose: int, cli_line: str, t0: float, device) -> int:
    """Long-read + SAM path (gdiet_tpu/runtime.py:516-674, the generic
    per-record writer): fragment batches of ``mini_batch_size`` bases
    through ``LongReadMapper.map_stream`` with its default budgets; with
    two files (or consecutive records sharing a qname) the segments of a
    fragment are revcomp'd per ``pe_ori``, paired (mm_pair) and written
    with mate fields."""
    from gdiet_tpu_torch.oracle import hit as ohit
    from gdiet_tpu_torch.pipeline.longread import LongReadMapper

    mapper = LongReadMapper(mi, mo, n_threads=n_threads, device=device)
    bout = _open_sam(out_path, mi, cli_line)
    names = mi.names
    n_mapped = 0

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
                lines = [samio.sam_record(
                    rec.name, rec.seq, rec.qual, r, regs, names, mo.flag, 0,
                    j, n, mate, index=mi, comment=rec.comment)
                    for r in regs or []
                    if not ((mo.flag & cfg.MM_F_NO_PRINT_2ND) and r.id != r.parent)]
                if not regs:
                    lines = [samio.sam_record(
                        rec.name, rec.seq, rec.qual, None, [], names, mo.flag,
                        0, j, n, mate, index=mi, comment=rec.comment)]
                bout.write("".join(l + "\n" for l in lines).encode())

    query_groups = [queries] if len(queries) == 2 else [[q] for q in queries]
    for group in query_groups:
        frag_batches = list(read_frag_batches(group, mo.mini_batch_size))
        # pe_ori-revcomp paired segments before mapping, flip coordinates
        # back after (worker_for, map.c:1057-1090)
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
        for fb, flat, flip, results in zip(frag_batches, flat_batches, flips,
                                           mapper.map_stream(flat_batches)):
            if mo.pe_ori >= 0 and (mo.flag & cfg.MM_F_CIGAR):
                # mm_pair on mapping-orientation regs; frag_gap bound as in
                # gdiet_tpu/runtime.py:636-653
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
            emit_frags(fb, results)
    _close_and_report(bout, n_mapped, verbose, cli_line, t0)
    return 0


def run_mapping(io, mo, variant: str, target: str, queries: list,
                device, fnw: str | None = None, out_path: str | None = None,
                n_threads: int = 3, verbose: int = 3,
                cli_line: str = "gdiet") -> int:
    """Build or load the index on ``device``, then map. Short reads
    (single-end and paired-end) and long reads to SAM are ported;
    everything else raises."""
    t0 = time.perf_counter()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[ERROR] --device cuda: no CUDA device is available")
    unsupported = []
    if queries and not (mo.flag & cfg.MM_F_OUT_SAM):
        unsupported.append("PAF output (use -a)")
    if len(queries) > 2 and variant == "sr":
        unsupported.append("more than two query files")
    if variant == "sr" and len(queries) == 2 and (
            os.environ.get("GDIET_NO_PE_FAST") or mo.pe_ori < 0
            or not (mo.flag & cfg.MM_F_CIGAR) or debug.enabled()
            or mo.sdust_thres > 0):
        # gdiet_tpu/runtime.py:503-513 sends these to its generic
        # per-record paired-end writer
        unsupported.append("the generic paired-end path (GDIET_NO_PE_FAST, "
                           "pe_ori < 0, no CIGAR, --print-seeds or -T)")
    if mo.split_prefix or mo.split_len > 0:
        unsupported.append("--split-prefix / --split-reads")
    if mo.mesh_shape is not None:
        unsupported.append("--mesh")
    if mo.flag & (cfg.MM_F_COPY_COMMENT | cfg.MM_F_OUT_MD | cfg.MM_F_OUT_CS
                  | cfg.MM_F_OUT_CS_LONG | cfg.MM_F_OUT_CG):
        unsupported.append("-y/--MD/--cs/-c")
    if unsupported:
        raise NotImplementedError(
            "not ported to gdiet_tpu_torch yet (see ROADMAP.md): "
            + ", ".join(unsupported))
    mi = load_or_build_index(target, io, device, verbose, t0)
    if fnw:
        mi.save(fnw)
        _log(verbose, t0, f"dumped the index to {fnw}")
    if not queries:
        return 0
    if variant != "sr":
        return run_lr_sam(mi, mo, queries, out_path, n_threads, verbose,
                          cli_line, t0, device)
    # GDIET_DP_FOLD=1 takes the folded DP, as it does in gdiet_tpu
    dp_fold = os.environ.get("GDIET_DP_FOLD", "0") == "1"
    if len(queries) == 2:
        return run_sr_pe_sam(mi, mo, queries[0], queries[1], out_path,
                             n_threads, verbose, cli_line, t0, device,
                             dp_fold=dp_fold)
    return run_sr_sam(mi, mo, queries[0], out_path, n_threads, verbose,
                      cli_line, t0, device, dp_fold=dp_fold)
