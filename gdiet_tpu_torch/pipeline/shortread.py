"""Batched short-read mapping to SAM: fused step on the device + native
host finish, with a wider retry tier and the scalar-oracle fallback.

Port of ``gdiet_tpu/pipeline/shortread.py::ShortReadMapper`` (single-end
SR; see that module for the design). Reads outside the fixed-shape envelope
(length > 300, budget overflows, occurrence streaks, an active query-occ
filter, window geometry outside the budget) are re-mapped by the
wider-budget retry tier and then, if still outside, by the scalar oracle,
so the SAM is identical to the reference's.

Not ported yet: paired-end, the multi-device mesh and the five-stage
profile re-run (``NotImplementedError``).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from gdiet_tpu_torch import _host
from gdiet_tpu_torch.ops.dp import cigars_from_ops
from gdiet_tpu_torch.pipeline.device_step import (TorchFusedMapper,
                                                  unpack_ops, unpack_outputs)

oal = _host.align
PROFILE, Stage = _host.profile.PROFILE, _host.profile.Stage


class ShortReadMapper:
    """Batched device mapper with oracle-exact host fallback."""

    def __init__(self, index, mo, max_read_len: int = 256,
                 seed_budget: int = 160, shift_seed_budget: int = 64,
                 hit_budget: int = 2048, dp_frac: float = 0.5, mesh=None,
                 retry_hit_budget: int = 2048, retry_batch: int = 512,
                 n_threads: int = 1, profile_stages: bool = False,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device mapping is not ported yet: see ROADMAP.md")
        if profile_stages:
            raise NotImplementedError(
                "the five-stage profile re-run is not ported yet: see ROADMAP.md")
        self.native = _host.require_native()
        self.mi = index
        self.mo = mo
        self.device = torch.device(device if device is not None else index.device)
        self.mid_occ = index.derive_mid_occ(mo)
        self.Lmax = max_read_len
        self.fused = TorchFusedMapper(
            index, mo, Lmax=max_read_len, S=seed_budget, S2=shift_seed_budget,
            A=hit_budget, dp_frac=dp_frac, device=self.device)
        self._oracle_index = None
        self._retry_args = (seed_budget, shift_seed_budget, retry_hit_budget)
        self.retry_batch = retry_batch
        self._retry_fused = None
        self.n_threads = max(1, n_threads)
        self._pool = None
        self._rn = None
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
    def _oracle_mi(self):
        """The index as the scalar oracle reads it."""
        if self._oracle_index is None:
            mi = self.mi

            class _Wrap:
                w, k, pattern = mi.w, mi.k, mi.pattern
                names, lengths = mi.names, [int(x) for x in mi.lengths]

                @staticmethod
                def get(minier):
                    return mi.get(minier)

                @staticmethod
                def getseq(rid, st, en, rev=False):
                    return mi.getseq(rid, st, en, rev)

            self._oracle_index = _Wrap()
        return self._oracle_index

    # ------------------------------------------------------------------
    def _prepare_and_dispatch(self, reads):
        _t0 = time.perf_counter_ns()
        codes, lens = self.native.encode_batch([r.seq for r in reads], self.Lmax)
        host_only = lens > min(300, self.Lmax)
        if _host.debug.enabled():  # --print-seeds traces the oracle
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
        if dev is not None:
            with PROFILE.stage(Stage.HOST_BLOBS):
                blobs = self.native.make_sr_blobs(
                    [reads[i].name for i in device_idx],
                    [reads[i].seq for i in device_idx],
                    [reads[i].qual or "" for i in device_idx])
        return reads, codes, lens, host_only, device_idx, dev, blobs

    def map_stream_sam(self, batches, rep_len: int = 0):
        """Pipelined mapping straight to SAM text: yields one ``bytes``-like
        blob of newline-terminated records per batch, in read order
        (shortread.py:290-356). A batch is a list of reads or a ``(reads,
        n_real)`` tuple whose tail is padding. A producer thread encodes and
        dispatches batch k+1 before fetching batch k, while this thread runs
        the native finish. Accumulates ``self.stats``."""
        self.stats = {"fallback_reads": 0, "n_records": 0}
        q: queue.Queue = queue.Queue(maxsize=2)

        def fetch(state):
            dev, device_idx = state[5], state[4]
            if dev is None:
                return None
            with PROFILE.stage(Stage.DEVICE_FUSED):
                return self.fused.fetch(dev, len(device_idx))

        def producer():
            try:
                prev = None
                for batch in batches:
                    batch, n_real = (batch if isinstance(batch, tuple)
                                     else (batch, len(batch)))
                    state = (*self._prepare_and_dispatch(batch), n_real)
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
            state, fetched = item
            yield self._finish_sam(state, rep_len, fetched)
        t.join()

    def map_stream_sam_pe(self, pair_batches, rep_len: int = 0):
        raise NotImplementedError(
            "paired-end mapping is not ported yet: see ROADMAP.md")

    def _oracle_sam(self, rec, rep_len: int) -> bytes:
        """Scalar-oracle mapping + Python SAM formatting for one read."""
        regs = _host.oracle_pipeline.map_read(
            self._oracle_mi(), rec.seq, self.mo, self.mid_occ, rec.name)
        return self._regs_to_sam(rec, regs, rep_len)

    def _regs_to_sam(self, rec, regs, rep_len: int) -> bytes:
        mo = self.mo
        samio = _host.sam
        no_2nd = mo.flag & _host.config.MM_F_NO_PRINT_2ND
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
        cfgm = _host.config
        B = len(reads)
        spans: list = [None] * B
        buf = b""
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
                    0 if (mo.flag & cfgm.MM_F_NO_PRINT_2ND) else mo.best_n,
                    bool(mo.flag & cfgm.MM_F_NO_PRINT_2ND),
                    bool(mo.flag & cfgm.MM_F_SOFTCLIP), rep_len, blobs=blobs)
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
        max_nb_sec = 0 if (mo.flag & _host.config.MM_F_NO_PRINT_2ND) else mo.best_n
        for i in range(B):
            if not fallback[i] and regs_per_read[i]:
                _host.oracle_pipeline.set_sam_params(
                    regs_per_read[i], int(lens_np[i]), mo.a, max_nb_sec)
        return regs_per_read, fallback
