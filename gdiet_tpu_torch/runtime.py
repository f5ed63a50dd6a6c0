"""File-level mapping driver of the port (the mm_map_file analog).

Port of ``gdiet_tpu/runtime.py`` for the short-read SAM path
(``_run_sr_sam_fast``): reads stream in fixed-shape batches through
``ShortReadMapper.map_stream_sam`` with one-batch lookahead, budgets scaled
to the observed read length, and an adaptive re-tier to a wider Lmax when
long reads keep arriving. Other variants and outputs raise
``NotImplementedError``.
"""

from __future__ import annotations

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


def run_sr_sam(mi, mo, query: str, out_path: str | None, n_threads: int,
               verbose: int, cli_line: str, t0: float, device,
               batch_reads: int = 8192) -> int:
    """SR + SAM path (gdiet_tpu/runtime.py:192-335): fixed batch shape,
    tail batch padded, Lmax from the first batch, re-tier after enough
    length-overflow reads."""
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    samio = _host.sam
    rdr = _host.fastx.read_fastx(query)
    first = []
    for rec in rdr:
        first.append(rec)
        if len(first) >= batch_reads:
            break
    bout = (open(out_path, "wb") if out_path and out_path != "-"
            else sys.stdout.buffer)
    bout.write(samio.sam_header(mi.names, [int(x) for x in mi.lengths],
                                cli_line, __version__).encode())
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
                dp_frac=0.3125, n_threads=n_threads, device=device)

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
    return 0


def run_mapping(io, mo, variant: str, target: str, queries: list,
                device, fnw: str | None = None, out_path: str | None = None,
                n_threads: int = 3, verbose: int = 3,
                cli_line: str = "gdiet") -> int:
    """Build or load the index on ``device``, then map. Only single-end
    short reads to SAM are ported; everything else raises."""
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
    if len(queries) > 1:
        unsupported.append("paired-end / several query files")
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
    return run_sr_sam(mi, mo, queries[0], out_path, n_threads, verbose,
                      cli_line, t0, device)
