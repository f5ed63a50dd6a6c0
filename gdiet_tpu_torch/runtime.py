"""File-level mapping driver of the port (the mm_map_file analog).

Port of ``gdiet_tpu/runtime.py`` for the short-read SAM paths: single-end
(``_run_sr_sam_fast``) streams reads in fixed-shape batches through
``ShortReadMapper.map_stream_sam`` with one-batch lookahead, budgets scaled
to the observed read length, and an adaptive re-tier to a wider Lmax when
long reads keep arriving; paired-end (``_run_sr_pe_sam_fast``) streams
pairs from two FASTQs through ``map_stream_sam_pe``. Other variants and
outputs raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import resource
import sys
import time

import torch

from gdiet_tpu_torch import _host
from gdiet_tpu_torch.index.build import TorchIndex, build_index

PROFILE, Stage = _host.profile.PROFILE, _host.profile.Stage
__version__ = _host.__version__


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
        mi = build_index(((r.name, r.seq) for r in _host.fastx.read_fastx(target)),
                         io, device)
    _log(verbose, t0, f"built the index for {mi.n_seq} target sequence(s)")
    return mi


def _open_sam(out_path: str | None, mi, cli_line: str):
    """The SAM output stream with its header written."""
    bout = (open(out_path, "wb") if out_path and out_path != "-"
            else sys.stdout.buffer)
    bout.write(_host.sam.sam_header(mi.names, [int(x) for x in mi.lengths],
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

    rdr = _host.fastx.read_fastx(query)
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

    it1, it2 = _host.fastx.read_fastx(q1), _host.fastx.read_fastx(q2)
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


def run_mapping(io, mo, variant: str, target: str, queries: list,
                device, fnw: str | None = None, out_path: str | None = None,
                n_threads: int = 3, verbose: int = 3,
                cli_line: str = "gdiet") -> int:
    """Build or load the index on ``device``, then map. Single-end and
    paired-end short reads to SAM are ported; everything else raises."""
    cfg = _host.config
    t0 = time.perf_counter()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[ERROR] --device cuda: no CUDA device is available")
    unsupported = []
    if variant != "sr":
        unsupported.append("long-read presets")
    if queries and not (mo.flag & cfg.MM_F_OUT_SAM):
        unsupported.append("PAF output (use -a)")
    if len(queries) > 2:
        unsupported.append("more than two query files")
    if len(queries) == 2 and (
            os.environ.get("GDIET_NO_PE_FAST") or mo.pe_ori < 0
            or not (mo.flag & cfg.MM_F_CIGAR) or _host.debug.enabled()
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
    # GDIET_DP_FOLD=1 takes the folded DP, as it does in gdiet_tpu
    dp_fold = os.environ.get("GDIET_DP_FOLD", "0") == "1"
    if len(queries) == 2:
        return run_sr_pe_sam(mi, mo, queries[0], queries[1], out_path,
                             n_threads, verbose, cli_line, t0, device,
                             dp_fold=dp_fold)
    return run_sr_sam(mi, mo, queries[0], out_path, n_threads, verbose,
                      cli_line, t0, device, dp_fold=dp_fold)
