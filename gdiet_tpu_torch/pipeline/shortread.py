"""Batched short-read mapping: fused step on the device + host finish, with
a wider retry tier and the scalar-oracle fallback.

Port of ``gdiet_tpu/pipeline/shortread.py::ShortReadMapper`` (single-end
and paired-end SR; see that module for the design). Two outputs:

- regs (``map_batch``, ``map_stream``): per read, the list of
  ``oracle.align.Reg`` that the generic per-record writer, ``--split-prefix``
  and the ``Aligner`` API format; no SAM strings are built. A batch is
  mapped in device sub-batches of ``sub_batch_reads(cfg)`` reads.
- SAM text (``map_stream_sam``, ``map_stream_sam_pe``): the native host
  finish writes the records of a batch in one call.

Single-end reads outside the fixed-shape envelope (length > 300, budget
overflows, occurrence streaks, an active query-occ filter, window geometry
outside the budget) are re-mapped by the wider-budget retry tier and then,
if still outside, by the scalar oracle, so the output is identical to the
reference's. Paired-end pairs outside it take the oracle directly, as in
``gdiet_tpu``.

``ShortReadMapper(mesh=...)`` maps over a (data, ref) mesh of devices
(``parallel/dist.py::ShardedFused``: reads split across the data rows, the
index split by key range, the shards' hits merged on the device) with the
same host finish; its retry tier stays one un-meshed mapper on the mesh's
first device. ``profile_stages=True`` (``-v 4``) re-runs each SAM batch cut
at the stage boundaries (``staged_times``) and adds the four stages'
times to ``PROFILE``.
"""

from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np
import torch

from gdiet_tpu_torch import config, debug, native
from gdiet_tpu_torch.io import sam as samio
from gdiet_tpu_torch.io.fastx import SeqRecord
from gdiet_tpu_torch.oracle import align as oal
from gdiet_tpu_torch.oracle import hit as oracle_hit
from gdiet_tpu_torch.oracle import pipeline as oracle_pipeline
from gdiet_tpu_torch.ops.backtrack import unpack_ops
from gdiet_tpu_torch.ops.dp import cigars_from_ops
from gdiet_tpu_torch.parallel.dist import ShardedFused
from gdiet_tpu_torch.pipeline.device_step import TorchFusedMapper, unpack_outputs
from gdiet_tpu_torch.utils.profile import PROFILE, Stage


# device memory that one fused call of the regs path may take, and the
# hit streams' share per hit slot (the streams, their concatenated copy and
# the expansion's temporaries): chip_smoke.py's generic phase measured a
# peak of 317 KB per read at A = 2,048, K = 2, Lmax 256 on an NVIDIA H100
# 80GB HBM3, of which 131 KB are DP dirs, so ~45 bytes per slot
DEVICE_BYTES = 24 << 30
STREAM_BYTES_PER_HIT = 48


def sub_batch_reads(cfg) -> int:
    """Reads per fused call on the regs path (map_batch, map_stream): the
    hit streams of A slots per strand and the DP dirs of the K * dp_frac
    rows of a read, (2 Lmax - 1) wavefronts x round16(Lmax) bytes each,
    within DEVICE_BYTES; at least 1,024 and at most 65,536 reads. At the
    default budgets (A = 2,048, Lmax 256, K = 20) a whole 50 Mbp mini-batch
    (~333k reads of 150 bp) would not fit on an 80 GB card."""
    stream = STREAM_BYTES_PER_HIT * 2 * (cfg.A + 1)
    dirs = cfg.K * cfg.dp_frac * (2 * cfg.Lmax - 1) * (-(-cfg.Lmax // 16) * 16)
    return int(max(1024, min(65536, DEVICE_BYTES // (stream + dirs))))


class ShortReadMapper:
    """Batched device mapper with oracle-exact host fallback."""

    def __init__(self, index, mo, max_read_len: int = 256,
                 seed_budget: int = 160, shift_seed_budget: int = 64,
                 hit_budget: int = 2048, dp_frac: float = 0.5, mesh=None,
                 retry_hit_budget: int = 2048, retry_batch: int = 512,
                 n_threads: int = 1, profile_stages: bool = False,
                 device=None):
        self.native = native.require_native()
        self.mi = index
        self.mo = mo
        self.mid_occ = index.derive_mid_occ(mo)
        self.Lmax = max_read_len
        self.profile_stages = profile_stages
        if mesh is not None:
            self.fused = ShardedFused(
                index, mo, mesh, Lmax=max_read_len, S=seed_budget,
                S2=shift_seed_budget, A=hit_budget, dp_frac=dp_frac)
            self.device = self.fused.device
        else:
            self.device = torch.device(device if device is not None else index.device)
            self.fused = TorchFusedMapper(
                index, mo, Lmax=max_read_len, S=seed_budget, S2=shift_seed_budget,
                A=hit_budget, dp_frac=dp_frac, device=self.device)
        self._retry_args = (seed_budget, shift_seed_budget, retry_hit_budget)
        self.retry_batch = retry_batch
        self._retry_fused = None
        self.n_threads = max(1, n_threads)
        self._pool = None
        self._rn = None
        self.device_batch = sub_batch_reads(self.fused.cfg)
        self.stats = {"fallback_reads": 0, "n_records": 0}

    def _map_oracle(self, fn, items):
        if self.n_threads > 1 and len(items) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.n_threads)
            return list(self._pool.map(fn, items))
        return [fn(x) for x in items]

    # ------------------------------------------------------------------
    def _retry_mapper(self):
        """Wider-budget step for reads that overflow the primary envelope
        (shortread.py:104-126); None when no budget would widen."""
        S, S2, A2 = self._retry_args
        cfg = self.fused.cfg
        wider = (A2 > cfg.A) or (min(4 * S, 256) > cfg.S) or (cfg.dp_frac < 1.0)
        if not wider:
            return None
        if self._retry_fused is None:
            self._retry_fused = TorchFusedMapper(
                self.mi, self.mo, Lmax=self.Lmax, S=min(4 * S, 256), S2=S2,
                A=max(A2, cfg.A), dp_frac=1.0, device=self.device)
        return self._retry_fused

    def _retry_batch_regs(self, reads_sub):
        """Map overflow reads through the retry tier; regs per read, None
        where it still fell back."""
        rf = self._retry_mapper()
        out: list = [None] * len(reads_sub)
        if rf is None:
            return out
        RB = self.retry_batch
        for s0 in range(0, len(reads_sub), RB):
            chunk = reads_sub[s0 : s0 + RB]
            codes, lens = self.native.encode_batch(
                [r.seq for r in chunk] + [""] * (RB - len(chunk)), self.Lmax)
            regs_list, fb = self._finish_device(
                rf.fetch(rf(codes, lens), RB), codes, lens, rf.cfg.K)
            for j in range(len(chunk)):
                if not fb[j]:
                    out[s0 + j] = regs_list[j]
        return out

    # ------------------------------------------------------------------
    def map_batch(self, reads: list) -> list:
        """Regs per read (a list of ``oracle.align.Reg``, empty when the
        read is unmapped), in read order (shortread.py:181-183). A batch
        larger than ``self.device_batch`` (``sub_batch_reads``) reads maps in
        device sub-batches of that size: reads map independently, so the
        regs are the same."""
        DB = self.device_batch
        out: list = []
        for s0 in range(0, len(reads), DB):
            state = self._prepare_and_dispatch(reads[s0:s0 + DB], sam=False)
            out += self._finish(state, self._fetch_state(state))
        return out

    def map_stream(self, batches):
        """Pipelined ``map_batch`` over an iterable of read lists: yields
        one list of regs per batch, in order (shortread.py:185-196). A
        producer thread dispatches (sub-)batch k+1 before batch k's host
        finish runs here."""
        DB = self.device_batch
        parts: collections.deque = collections.deque()  # [pieces left, regs]

        def pieces():
            for batch in batches:
                n = max(1, -(-len(batch) // DB))
                parts.append([n, []])
                for s0 in range(n):
                    yield batch[s0 * DB:(s0 + 1) * DB]

        for regs in self._pipelined(
                pieces(), lambda reads, n: self._prepare_and_dispatch(reads, sam=False),
                self._fetch_state, self._finish):
            cur = parts[0]
            cur[1] += regs
            cur[0] -= 1
            if cur[0] == 0:
                parts.popleft()
                yield cur[1]

    def _fetch_state(self, state):
        """(meta, ops) numpy of a dispatched batch, None if nothing was
        dispatched."""
        dev, device_idx = state[5], state[4]
        if dev is None:
            return None
        with PROFILE.stage(Stage.DEVICE_FUSED):
            return self.fused.fetch(dev, len(device_idx))

    def _finish(self, state, fetched) -> list:
        """Regs per read of one dispatched batch (shortread.py:260-287):
        the device rows through ``_finish_device``, rows that fell back
        through the retry tier, the rest and the host-only reads through
        the scalar oracle."""
        reads, codes, lens, host_only, device_idx = state[:5]
        host_only = host_only.copy()
        results: list = [None] * len(reads)
        retry_i: list = []
        if fetched is not None:
            with PROFILE.stage(Stage.HOST_FINISH):
                dev_results, fb = self._finish_device(
                    fetched, codes[device_idx], lens[device_idx], self.fused.cfg.K)
            for j, i in enumerate(device_idx):
                if fb[j]:
                    retry_i.append(i)
                else:
                    results[i] = dev_results[j]
        if retry_i:  # the wider device tier before the oracle
            retried = self._retry_batch_regs([reads[i] for i in retry_i])
            for i, regs in zip(retry_i, retried):
                if regs is not None:
                    results[i] = regs
                else:
                    host_only[i] = True
            self.stats["retried_reads"] = self.stats.get("retried_reads", 0) + len(retry_i)
        idx = np.where(host_only)[0].tolist()
        for i, regs in zip(idx, self._map_oracle(
                lambda i: oracle_pipeline.map_read(
                    self.mi.oracle_view(), reads[i].seq, self.mo, self.mid_occ,
                    reads[i].name), idx)):
            results[i] = regs
        self.stats["fallback_reads"] += len(idx)
        return results

    def _prepare_and_dispatch(self, reads, sam: bool = True):
        _t0 = time.perf_counter_ns()
        codes, lens = self.native.encode_batch([r.seq for r in reads], self.Lmax)
        host_only = lens > min(300, self.Lmax)
        if debug.enabled():  # --print-seeds traces the oracle
            host_only[:] = True
        if self.mo.sdust_thres > 0:  # -T routing is per read (map.c:45-72)
            host_only |= self.native.sdust_flags(
                [r.seq for r in reads], self.mo.sdust_thres).astype(bool)
        device_idx = np.where(~host_only)[0]
        dev = None
        if len(device_idx):
            # enqueues the whole step on the device stream and returns
            dev = self.fused(codes[device_idx], lens[device_idx])
        PROFILE.add(Stage.HOST_PREP, time.perf_counter_ns() - _t0)
        blobs = None
        if sam and dev is not None:  # SAM strings built while the step runs
            with PROFILE.stage(Stage.HOST_BLOBS):
                blobs = self.native.make_sr_blobs(
                    [reads[i].name for i in device_idx],
                    [reads[i].seq for i in device_idx],
                    [reads[i].qual or "" for i in device_idx])
        return reads, codes, lens, host_only, device_idx, dev, blobs

    def _pipelined(self, batches, prepare, fetch, finish):
        """Yield ``finish(state, fetched)`` per batch, in order. A batch is
        a list or a ``(items, n_real)`` tuple whose tail is padding. A
        producer thread runs ``prepare(items, n_real)`` (encode + device
        dispatch) for batch k+1 before ``fetch(state)`` of batch k, while
        this thread runs the host finish."""
        q: queue.Queue = queue.Queue(maxsize=2)

        def producer():
            try:
                prev = None
                for batch in batches:
                    items, n_real = (batch if isinstance(batch, tuple)
                                     else (batch, len(batch)))
                    state = prepare(items, n_real)
                    if prev is not None:
                        q.put((prev, fetch(prev)))
                    prev = state
                if prev is not None:
                    q.put((prev, fetch(prev)))
            except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
                q.put(e)
            else:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield finish(*item)
        t.join()

    def map_stream_sam(self, batches, rep_len: int = 0):
        """Pipelined mapping straight to SAM text: yields one ``bytes``-like
        blob of newline-terminated records per batch of reads, in read
        order (shortread.py:290-356). Accumulates ``self.stats``."""
        self.stats = {"fallback_reads": 0, "n_records": 0}
        return self._pipelined(
            batches, lambda reads, n: (*self._prepare_and_dispatch(reads), n),
            self._fetch_state,
            lambda state, fetched: self._finish_sam(state, rep_len, fetched))

    # ------------------------------------------------------------------
    # Paired-end (shortread.py:483-659): both ends map as ordinary fused-
    # step rows (even rows R1, odd rows R2, pe_ori-revcomp'd); pairing and
    # the mate-field SAM records run in one native call per batch
    # (pe_finish_batch: mm_pair pe.c:76-177 + format.c:432-530). There is
    # no retry tier: pairs outside the envelope take the oracle.
    # ------------------------------------------------------------------
    def _pe_gap(self) -> int:
        """Pair gap bound: the reference never computes frag_gap; bound it
        by the frag-mode fragment budget (map.c:621-622)."""
        mo = self.mo
        return (mo.max_gap_ref if mo.max_gap_ref >= 0
                else max(mo.max_gap, mo.max_frag_len or 800))

    def _pe_flips(self) -> tuple[int, int]:
        pe_ori = self.mo.pe_ori
        return (pe_ori >> 1) & 1, pe_ori & 1

    def map_stream_sam_pe(self, pair_batches, rep_len: int = 0):
        """Pipelined paired-end mapping straight to SAM text: yields one
        blob per batch of read PAIRS, order preserved. A batch is a list of
        (r1, r2) ORIGINAL records or a ``(pairs, n_real)`` tuple with a
        padded tail. Pairs outside the envelope take the exact oracle and
        the Python writer (identical output). Accumulates ``self.stats``."""
        self.stats = {"fallback_reads": 0, "n_records": 0}

        def fetch(state):
            with PROFILE.stage(Stage.DEVICE_FUSED):
                return self.fused.fetch(state[4], 2 * len(state[0]))

        return self._pipelined(
            pair_batches, self._prepare_pe, fetch,
            lambda state, fetched: self._finish_pe(state, rep_len, fetched))

    def _prepare_pe(self, pairs, n_real: int):
        _t0 = time.perf_counter_ns()
        f0, f1 = self._pe_flips()
        revcomp = samio.revcomp
        mseqs: list = []
        for r1, r2 in pairs:
            mseqs.append(revcomp(r1.seq) if f0 else r1.seq)
            mseqs.append(revcomp(r2.seq) if f1 else r2.seq)
        codes, lens = self.native.encode_batch(mseqs, self.Lmax)
        host_only_pair = (lens > min(300, self.Lmax)).reshape(-1, 2).any(axis=1)
        dev = self.fused(codes, lens)
        PROFILE.add(Stage.HOST_PREP, time.perf_counter_ns() - _t0)
        with PROFILE.stage(Stage.HOST_BLOBS):
            names: list = []
            seqs: list = []
            quals: list = []
            for r1, r2 in pairs:
                names += [r1.name, r2.name]
                seqs += [r1.seq, r2.seq]
                quals += [r1.qual or "", r2.qual or ""]
            blobs = self.native.make_sr_blobs(names, seqs, quals)
        return pairs, codes, lens, host_only_pair, dev, blobs, n_real

    def _finish_pe(self, state, rep_len: int, fetched) -> bytes:
        pairs, codes, lens, host_only, _, blobs, n_real = state
        mo = self.mo
        meta_np, ops_np = fetched
        f0, f1 = self._pe_flips()
        rn_blob, rn_offs = self._ref_names()
        with PROFILE.stage(Stage.HOST_FINISH):
            res = self.native.pe_finish_batch(
                meta_np, ops_np, self.fused.cfg.K, self.fused.cfg.Lmax,
                codes, lens, self.mi.codes, self.mi.seq_offsets, rn_blob, rn_offs,
                mo.a, mo.b, mo.q, mo.e, mo.min_dp_max,
                0 if (mo.flag & config.MM_F_NO_PRINT_2ND) else mo.best_n,
                bool(mo.flag & config.MM_F_NO_PRINT_2ND),
                bool(mo.flag & config.MM_F_SOFTCLIP), rep_len,
                bool(f0), bool(f1), self._pe_gap(), mo.pe_bonus, blobs=blobs)
        if res is None:
            raise RuntimeError("native pe_finish_batch failed")
        buf, rec_offs, done = res
        with PROFILE.stage(Stage.HOST_ASSEMBLE):
            ro = rec_offs.tolist()
            spans = [(ro[i], ro[i + 1]) if done[i] and not host_only[i] else None
                     for i in range(n_real)]
            view = memoryview(buf)
            out = []
            n_fb = 0
            i = 0
            while i < n_real:
                if spans[i] is not None:
                    s0, e0 = spans[i]
                    while i + 1 < n_real and spans[i + 1] is not None \
                            and spans[i + 1][0] == e0:
                        i += 1
                        e0 = spans[i][1]
                    out.append(view[s0:e0])
                else:
                    n_fb += 1
                    out.append(self._oracle_sam_pe(pairs[i], rep_len))
                i += 1
            self.stats["fallback_reads"] += n_fb
            blob = b"".join(out)
            self.stats["n_records"] += blob.count(b"\n")
        return blob

    def _oracle_sam_pe(self, pair, rep_len: int) -> bytes:
        """Exact oracle PE finish for one pair: map both pe_ori-revcomp'd
        ends, mm_pair, flip back, n_seg=2 records (shortread.py:612-659)."""
        mo = self.mo
        flips = self._pe_flips()
        recs = list(pair)
        mapped = [
            SeqRecord(rec.name, samio.revcomp(rec.seq),
                                  rec.qual[::-1] if rec.qual else None, rec.comment)
            if flips[j] else rec
            for j, rec in enumerate(recs)]
        results = [oracle_pipeline.map_read(
            self.mi.oracle_view(), m.seq, mo, self.mid_occ, m.name) for m in mapped]
        if mo.pe_ori >= 0 and (mo.flag & config.MM_F_CIGAR):
            oracle_hit.pair(self._pe_gap(), mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                                  [mapped[0].l_seq, mapped[1].l_seq], results)
        for j in range(2):
            if flips[j]:
                qlen = mapped[j].l_seq
                for r in results[j] or []:
                    r.qs, r.qe = qlen - r.qe, qlen - r.qs
                    r.rev = 0 if r.rev else 1
        lines = []
        for j, rec in enumerate(recs):
            regs, mate = results[j], results[1 - j]
            if regs:
                for r in regs:
                    if (mo.flag & config.MM_F_NO_PRINT_2ND) and r.id != r.parent:
                        continue
                    lines.append(samio.sam_record(
                        rec.name, rec.seq, rec.qual, r, regs, self.mi.names,
                        mo.flag, rep_len, j, 2, mate, index=self.mi))
            else:
                lines.append(samio.sam_record(
                    rec.name, rec.seq, rec.qual, None, [], self.mi.names,
                    mo.flag, rep_len, j, 2, mate))
        return ("\n".join(lines) + "\n").encode()

    def _oracle_sam(self, rec, rep_len: int) -> bytes:
        """Scalar-oracle mapping + Python SAM formatting for one read."""
        regs = oracle_pipeline.map_read(
            self.mi.oracle_view(), rec.seq, self.mo, self.mid_occ, rec.name)
        return self._regs_to_sam(rec, regs, rep_len)

    def _regs_to_sam(self, rec, regs, rep_len: int) -> bytes:
        mo = self.mo
        no_2nd = mo.flag & config.MM_F_NO_PRINT_2ND
        lines = []
        if regs:
            for r in regs:
                if no_2nd and r.id != r.parent:
                    continue
                lines.append(samio.sam_record(
                    rec.name, rec.seq, rec.qual, r, regs, self.mi.names,
                    mo.flag, rep_len, index=self.mi))
        else:
            lines.append(samio.sam_record(
                rec.name, rec.seq, rec.qual, None, [], self.mi.names,
                mo.flag, rep_len))
        return ("\n".join(lines) + "\n").encode()

    def _ref_names(self):
        if self._rn is None:
            self._rn = self.native._blob(list(self.mi.names))
        return self._rn

    def _finish_sam(self, state, rep_len: int, fetched) -> bytes:
        reads, codes, lens, host_only, device_idx, dev, blobs, n_real = state
        mo = self.mo
        B = len(reads)
        spans: list = [None] * B
        buf = b""
        if self.profile_stages and dev is not None:
            st = self.fused.staged_times(codes[device_idx], lens[device_idx])
            for stage, name in ((Stage.PATTERN_ALIGNMENT, "pattern"), (Stage.SEEDING, "seed"),
                                (Stage.VOTING, "vote"), (Stage.SEQUENCE_ALIGNMENT, "align")):
                PROFILE.add(stage, int(st[name] * 1e9))
        if dev is not None:
            meta_np, ops_np = fetched
            di = device_idx
            rn_blob, rn_offs = self._ref_names()
            with PROFILE.stage(Stage.HOST_FINISH):
                res = self.native.sr_finish_batch(
                    meta_np, ops_np, self.fused.cfg.K, self.fused.cfg.Lmax,
                    codes[di], lens[di], None, None, None,
                    self.mi.codes, self.mi.seq_offsets, rn_blob, rn_offs,
                    mo.a, mo.b, mo.q, mo.e, mo.min_dp_max,
                    0 if (mo.flag & config.MM_F_NO_PRINT_2ND) else mo.best_n,
                    bool(mo.flag & config.MM_F_NO_PRINT_2ND),
                    bool(mo.flag & config.MM_F_SOFTCLIP), rep_len, blobs=blobs)
            if res is None:
                raise RuntimeError("native sr_finish_batch failed")
            buf, rec_offs, done = res
            with PROFILE.stage(Stage.HOST_ASSEMBLE):
                if len(device_idx) == B and n_real == B and done.all():
                    end = int(rec_offs[B])
                    self.stats["n_records"] += buf.count(b"\n", 0, end)
                    return memoryview(buf)[:end]
                ro = rec_offs.tolist()
                for j, i in enumerate(di):
                    if done[j]:
                        spans[i] = (ro[j], ro[j + 1])
        retry_regs: dict = {}
        retry_i = [i for i in range(n_real) if spans[i] is None and not host_only[i]]
        if retry_i:  # the wider device tier before the oracle
            retried = self._retry_batch_regs([reads[i] for i in retry_i])
            for i, regs in zip(retry_i, retried):
                if regs is not None:
                    retry_regs[i] = regs
            self.stats["retried_reads"] = self.stats.get("retried_reads", 0) + len(retry_i)
        oracle_i = [i for i in range(n_real) if spans[i] is None and i not in retry_regs]
        oracle_blobs = dict(zip(oracle_i, self._map_oracle(
            lambda i: self._oracle_sam(reads[i], rep_len), oracle_i)))
        with PROFILE.stage(Stage.HOST_ASSEMBLE):
            view = memoryview(buf)
            out = []
            i = 0
            while i < n_real:
                if spans[i] is not None:
                    s0, e0 = spans[i]
                    while i + 1 < n_real and spans[i + 1] is not None \
                            and spans[i + 1][0] == e0:
                        i += 1
                        e0 = spans[i][1]
                    out.append(view[s0:e0])
                elif i in retry_regs:
                    out.append(self._regs_to_sam(reads[i], retry_regs[i], rep_len))
                else:
                    out.append(oracle_blobs[i])
                i += 1
            self.stats["fallback_reads"] += len(oracle_i)
            blob = b"".join(out)
            self.stats["n_records"] += blob.count(b"\n")
        return blob

    # ------------------------------------------------------------------
    def _finish_device(self, fetched, codes_np, lens_np, K: int):
        """Regs from fetched (meta, ops) for the retry tier
        (shortread.py:724-838): CIGARs from the op streams, native fix-ups
        and rescoring, filters, mm_set_sam_params."""
        mo, mi = self.mo, self.mi
        meta_np, ops2 = fetched
        B = len(lens_np)
        out = unpack_outputs(meta_np, K)
        fallback = out["fallback"]
        live = out["c_valid"] & ~fallback[:, None]
        rows = out["opsrow"].reshape(-1)
        need = np.where((live & ~out["exact"]).reshape(-1) & (rows >= 0))[0]
        cigs_by_n: dict = {}
        if len(need):
            op_rows = unpack_ops(ops2[rows[need]])
            sub = self.native.rle_ops(
                op_rows, out["fin_i"].reshape(-1)[need],
                out["fin_j"].reshape(-1)[need], out["length"].reshape(-1)[need])
            if sub is None:  # more runs than the C encoder holds
                sub = cigars_from_ops(
                    op_rows, out["fin_i"].reshape(-1)[need],
                    out["fin_j"].reshape(-1)[need], out["length"].reshape(-1)[need])
            cigs_by_n = dict(zip(need.tolist(), sub))

        regs_per_read: list = [[] for _ in range(B)]
        scan_jobs: list = []
        cand: list = []
        for i in range(B):
            if fallback[i]:
                continue
            qlen = int(lens_np[i])
            for c in range(K):
                if not live[i, c]:
                    continue
                n = i * K + c
                length = int(out["length"][i, c])
                rev = bool(out["c_strand"][i, c])
                so, eo = int(out["so"][i, c]), int(out["eo"][i, c])
                ts, te = int(out["ts"][i, c]), int(out["te"][i, c])
                chrom = int(out["chrom"][i, c])
                off = int(mi.seq_offsets[chrom])
                twin = mi.codes[off + ts : off + te + 1]
                if out["exact"][i, c]:
                    ez_score = qlen * mo.a
                    n_ambi = int((twin > 3).sum())
                    r = oal.Reg(
                        rid=chrom, score=ez_score, qs=so, qe=eo + 1, rs=ts,
                        re=te + 1, rev=rev, cigar=[(length, oal.CIGAR_MATCH)],
                        dp_score=ez_score, blen=length - n_ambi,
                        mlen=length - n_ambi, n_ambi=n_ambi,
                        dp_max=mo.a * (length - n_ambi))
                else:
                    ez_score = int(out["dp_score"][i, c])
                    cigar = ([(length, oal.CIGAR_MATCH)]
                             if out["opsrow"][i, c] == -2 else cigs_by_n.get(n, []))
                    r = oal.Reg(rid=chrom, score=ez_score, qs=so, qe=eo + 1,
                                rs=ts, re=te + 1, rev=rev, cigar=list(cigar),
                                dp_score=ez_score)
                    qwin = ((codes_np[i, so : eo + 1][::-1]) ^ 3 if rev
                            else codes_np[i, so : eo + 1])
                    scan_jobs.append((r, qwin, twin))
                cand.append((i, r))
        if scan_jobs:
            oal.update_extra_many(scan_jobs, mo.a, mo.b, mo.q, mo.e)
        for i, r in cand:
            qlen = int(lens_np[i])
            clip0 = qlen - r.qe if r.rev else r.qs
            clip1 = r.qs if r.rev else qlen - r.qe
            if not (clip0 < qlen and clip1 < qlen) or r.dp_score < mo.min_dp_max:
                continue
            lst = regs_per_read[i]
            lst.append(r)
            k = len(lst) - 1
            while k > 0 and lst[k].score > lst[k - 1].score:
                lst[k], lst[k - 1] = lst[k - 1], lst[k]
                k -= 1
        max_nb_sec = 0 if (mo.flag & config.MM_F_NO_PRINT_2ND) else mo.best_n
        for i in range(B):
            if not fallback[i] and regs_per_read[i]:
                oracle_pipeline.set_sam_params(
                    regs_per_read[i], int(lens_np[i]), mo.a, max_nb_sec)
        return regs_per_read, fallback
