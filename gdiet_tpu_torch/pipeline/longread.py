"""Long-read mapper: device front + banded DP on the device + exact host
finish.

Port of ``gdiet_tpu/pipeline/longread.py::LongReadMapper``. The device
front (``pipeline/lr_step.py``: shift inference, query sketch, cuckoo
lookup, hit expansion, round-1 vote, filters and both round-2 votes) runs
once per batch. The host accepts round-2 candidates, builds the
concatenation graph and the segment windows (``oracle/longread.py`` on the
``-t`` pool). Every segment's banded DP runs in length buckets on the
device: ``ops/extd2.py::extd2_batch`` with the band budget and an unroll of
8 (the banded lane window, ``csrc/extd2_band_i16.cu`` on the card) and
``backtrack_band`` (``csrc/backtrack_band.cu``), one packed u8 result per
chunk. The DP's lane state is ``extd2.route_state_dtype``'s: int16 for
every windowed bucket and the full-width (512, 1024) one where
``safe_state_dtype`` allows it (every preset), the outputs bit-equal to
int32's. Each chunk's CIGARs stay packed through the host's run-length
encoding and one native fix-and-rescore pass (``pipeline/lr_finish.py``),
and each read is finished from those rows on the calling thread
(``lr_finish.finish_read``, ``olr.finalize_read``'s steps).

The device is explicit: on the card every bucket runs the kernels, on the
CPU their plain versions (``gdiet_tpu`` runs the scalar ``oal.extd2`` off
the TPU instead). Segments beyond the largest bucket take ``oal.extd2`` on
the host, the reference's own routing (``stats["host_dp_segments"]``).
Reads outside the fixed-shape envelope map through the scalar oracle
``olr.map_read_lr`` (``stats["fallback_reads"]``).

The envelope, ``max_read_len``, is 32,768 bp by default: the query length
of the largest DP bucket, so a read the front maps fits a device bucket
whole, and HiFi and ONT reads of up to ~30 kb take the device path (an
oracle read costs the host ~30 ms/kbp). The default budgets hold such a
read of either preset: a seed budget of 4,096 (~1,500 minimizers on a
30 kb HiFi read's diet half at k 19, w 19; ~2,700 at ONT's k 15, w 10), a
shift budget of 1,024 (~300 shift seeds in the first fifth of a 30 kb HiFi
read at ``-i 0.2``, over the 256 of a smaller budget), a hit budget of
8,192, and no vote compaction (one to 4,096 columns sends back reads in
repeats; it saves the front no time). A read that overflows one goes back
to the oracle, which is exact (``stats["front_fallback_reads"]``). The
front takes a batch's reads longest first, in calls of at most
``FRONT_BASES`` padded bases (1,024 reads at 32,768 bp), each call as wide
as ``front_width`` of its longest read: the power of two that holds it,
512 at least and the envelope at most. So a batch of 4 kb reads, or one
read of the API, runs at 4,096 and not at 32,768, with its seed budgets
capped at that width's diet length (``device_step.at_width``: no read
that fits the width can reach the cap); a batch is never cut into more
calls than one width would take. Each call keeps its rows in read order,
so a batch of one call needs no reordering; several calls' metas are put
back in read order on the device, the index uploaded without a blocking
copy (which would wait for the whole front). A mini-batch of any size (up to 500 Mbp under ``map-hifi``) keeps each
[B, width] int64 temporary at 256 MiB and a call at ~4 GB of device
memory.

Each phase of a batch is a span of ``utils/profile.py::PROFILE`` (under
the caller's span, with the batch's id): ``lr.front`` (encode, H2D,
enqueue), ``lr.front_wait`` (the meta's D2H), ``lr.host_mid`` (votes,
round 2, segment prep), ``lr.dp_dispatch`` with ``lr.host_dp`` per host
segment, ``lr.dp_fetch`` with ``lr.dp_wait`` per chunk's D2H,
``lr.finish`` and ``lr.oracle`` with ``lr.oracle_read`` per read on the
pool (its ``len`` and ``reason``: ``len`` over the envelope, ``front``
sent back by the device front, ``host_only`` under ``-T`` or debug).
Counters: ``front_reads`` (reads sent to the front),
``front_fallback_reads`` (those its meta sent back), ``oracle_bases``,
``dp_segments`` (segments of device-path reads that need a DP: not an
exact match), ``host_dp_segments`` (those of them beyond the largest
bucket, on the host's ``oal.extd2``), ``finish_segments`` (segments that
reach a ``Reg``) and ``finish_py_segments`` (those of them finished by the
per-record ``oal.update_extra``: exact matches, host-DP segments, rows of
a chunk whose runs overflow).

``LongReadMapper(mesh=...)`` runs the front over a (data, ref) mesh
(``parallel/dist.py::sharded_lr_front``: reads split across the data rows,
the index split by key range, the shards' hit streams merged before the
votes); the device batch is padded to a multiple of the data-axis size
(length 0, ``cov_thr`` 0, ``vt_dis`` 1) and the meta sliced back. The
host finish and the segment DP, on the mesh's first device, are unchanged.
"""

from __future__ import annotations

from dataclasses import replace as dataclass_replace

import numpy as np
import torch

from gdiet_tpu_torch import config, debug, native
from gdiet_tpu_torch.io import sam as samio
from gdiet_tpu_torch.ops import extd2
from gdiet_tpu_torch.ops.dp_band import LR_UNROLL, window_geometry
from gdiet_tpu_torch.oracle import align as oal
from gdiet_tpu_torch.oracle import longread as olr
from gdiet_tpu_torch.parallel.dist import sharded_lr_front
from gdiet_tpu_torch.pipeline import lr_finish
from gdiet_tpu_torch.pipeline.device_step import _pattern_tables, at_width, pack_ops, step_config
from gdiet_tpu_torch.pipeline.lr_step import lr_front, unpack_lr_meta
from gdiet_tpu_torch.utils.profile import PROFILE

F32 = np.float32
U32 = 0xFFFFFFFF

# (Lq, Lt) DP buckets; segments beyond the largest take the host DP
DP_BUCKETS = [(512, 1024), (2048, 3072), (4096, 5120), (8192, 9216),
              (16384, 17408), (32768, 34048)]
# padded bases (reads x width) of one front call: its [B, width] int64
# temporaries stay at 256 MiB each whatever the mini-batch holds
FRONT_BASES = 1 << 25
FRONT_MIN_WIDTH = 512


def front_width(n: int, Lmax: int) -> int:
    """The row width of a front call whose longest read has ``n`` bases:
    the power of two that holds it, within [FRONT_MIN_WIDTH, Lmax]."""
    return min(Lmax, max(FRONT_MIN_WIDTH, 1 << (n - 1).bit_length()))


class LongReadMapper:
    """Batched long-read mapper on ``device`` with oracle-exact host
    fallback (longread.py:43-596)."""

    def __init__(self, index, mo, max_read_len: int = 32768,
                 seed_budget: int = 4096, shift_seed_budget: int = 1024,
                 hit_budget: int = 8192, vote_budget: int = 0,
                 n_threads: int = 1, device=None, mesh=None):
        native.require_native()
        self.mi = index
        self.mo = mo
        self.mesh = mesh
        self.device = (mesh.lead(0) if mesh is not None else
                       torch.device(device if device is not None else index.device))
        self.mid_occ = index.derive_mid_occ(mo)
        self.Lmax = max_read_len
        # -t analog (kt_for): prepare_segments and the oracle fallbacks
        # release the GIL inside numpy and C; the finish, bound by the
        # GIL, runs on the calling thread
        self.n_threads = max(1, n_threads)
        self._pool = None
        self.stats = {"fallback_reads": 0, "n_reads": 0, "dp_segments": 0,
                      "host_dp_segments": 0, "front_reads": 0,
                      "front_fallback_reads": 0, "oracle_bases": 0,
                      "finish_segments": 0, "finish_py_segments": 0}
        # mark(name), when set, is called at each phase boundary of a batch
        # (front, host_mid, dp, backtrack, d2h, host_finish)
        self.mark = None

        cfg = step_config(index, mo, max_read_len, seed_budget, shift_seed_budget,
                          hit_budget)
        # LR voting keeps vt_nb_loc candidates (map.c:1310); the front
        # applies mm_seed_mz_flt itself, so a read with a repeated
        # minimizer stays on the device
        cfg = dataclass_replace(cfg, K=mo.vt_nb_loc, vote_budget=vote_budget,
                                q_occ_drop=True)
        if mesh is not None:
            self.cfg = cfg
            self._mesh_front = sharded_lr_front(
                mesh, index, cfg, index.k, float(mo.vt_df1), float(mo.vt_f), int(mo.bw))
        else:
            tkv, c1, c2, nb = index.device_cuckoo_kv()
            self.cfg = dataclass_replace(cfg, cuckoo_c1=c1, cuckoo_c2=c2, cuckoo_nb=nb)
            self.tables = {"cuckoo": tkv.to(self.device),
                           "positions": index.device_positions().to(self.device)}
            self._widths: dict = {}  # front width -> (its StepConfig, its tables)

    def _mark(self, name: str) -> None:
        if self.mark is not None:
            self.mark(name)

    # ------------------------------------------------------------------
    def _map_parallel(self, fn, items):
        """Run ``fn`` over items on the -t pool (order-preserving)."""
        if self.n_threads > 1 and len(items) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.n_threads)
            return list(self._pool.map(fn, items))
        return [fn(x) for x in items]

    # ------------------------------------------------------------------
    def map_batch(self, reads: list) -> list:
        return self._tail_batch(self._mid_batch(self._start_batch(reads)))

    def map_stream(self, batches):
        """Two-deep pipeline: while the host votes and prepares batch k,
        the device computes batch k+1's front; while the device runs batch
        k's segment DP, the host finishes batch k-1. Stage order per
        iteration: start(k+1), mid(k), tail(k-1)."""
        started = None
        midded = None
        for batch in batches:
            new = self._start_batch(batch)
            if started is not None:
                m = self._mid_batch(started)
                if midded is not None:
                    yield self._tail_batch(midded)
                midded = m
            started = new
        if started is not None:
            m = self._mid_batch(started)
            if midded is not None:
                yield self._tail_batch(midded)
            midded = m
        if midded is not None:
            yield self._tail_batch(midded)

    def regs_to_sam_lines(self, rec, regs, rep_len: int = 0) -> list:
        """SAM record lines of one read (format.c:412-602 via io/sam.py)."""
        mo = self.mo
        if not regs:
            return [samio.sam_record(rec.name, rec.seq, rec.qual, None, [],
                                     self.mi.names, mo.flag, rep_len)]
        return [samio.sam_record(rec.name, rec.seq, rec.qual, r, regs,
                                 self.mi.names, mo.flag, rep_len, index=self.mi)
                for r in regs
                if not ((mo.flag & config.MM_F_NO_PRINT_2ND) and r.id != r.parent)]

    def _start_batch(self, reads):
        B = len(reads)
        batch = PROFILE.next_batch()
        results: list = [None] * B
        lens = np.array([r.l_seq for r in reads], np.int64)
        # why each read takes the oracle ("" for none yet)
        why = np.full(B, "", object)
        if self.mo.sdust_thres > 0 or debug.enabled():
            why[:] = "host_only"
        else:
            why[(lens > self.Lmax) | (lens == 0)] = "len"
        device_idx = np.where(why == "")[0]
        self.stats["front_reads"] += len(device_idx)
        front = None
        if len(device_idx):
            with PROFILE.span("lr.front", batch=batch):
                front = self._dispatch_front([reads[i] for i in device_idx],
                                             lens[device_idx])
        return reads, results, lens, why, device_idx, front, batch

    def _mid_batch(self, st):
        """Host vote + round-2 + job prep; ends with the segment DP chunks
        enqueued on the device."""
        reads, results, lens, why, device_idx, front, batch = st
        dev = None
        if len(device_idx):
            dev = self._map_device_mid(lens[device_idx], results, device_idx, front, batch)
        return reads, results, lens, why, device_idx, dev, batch

    def _tail_batch(self, st):
        """Fetch the DP results, finish device reads, run host fallbacks."""
        reads, results, lens, why, device_idx, dev, batch = st
        if dev is not None:
            fb = self._map_device_tail(dev, batch)
            why[device_idx[fb]] = "front"
            self.stats["front_fallback_reads"] += int(fb.sum())
        fb_idx = [int(i) for i in np.where(why != "")[0]]
        self.stats["fallback_reads"] += len(fb_idx)
        self.stats["n_reads"] += len(reads)
        self.stats["oracle_bases"] += int(lens[fb_idx].sum())
        if fb_idx:
            with PROFILE.span("lr.oracle", batch=batch) as parent:
                fb_res = self._map_parallel(
                    lambda i: self._oracle_read(reads[i], why[i], parent), fb_idx)
            for i, r in zip(fb_idx, fb_res):
                results[i] = r
        return results

    def _oracle_read(self, rec, reason: str, parent):
        """One read through the scalar oracle; ``parent`` is given since
        the pool's threads inherit no span."""
        with PROFILE.span("lr.oracle_read", parent=parent, len=rec.l_seq, reason=reason):
            return olr.map_read_lr(self.mi.oracle_view(), rec.seq, self.mo,
                                   self.mid_occ, rec.name)

    # ------------------------------------------------------------------
    def _dispatch_front(self, reads, lens_np):
        """Encode and enqueue the device front: the reads cut longest first
        into calls of at most ``FRONT_BASES`` padded bases, each
        ``front_width`` of its longest read wide, its rows in read order.
        Returns each read's codes row and the metas [B, ...] in read
        order."""
        mo = self.mo
        cov_thr = np.array([int(F32(n) * F32(mo.vt_cov)) for n in lens_np], np.int32)
        vt_dis = np.full(len(reads), mo.vt_dis, np.uint64).view(np.int64)
        order = np.argsort(-lens_np, kind="stable")
        calls, c0 = [], 0
        while c0 < len(order):
            n = max(1, FRONT_BASES // front_width(int(lens_np[order[c0]]), self.Lmax))
            calls.append(np.sort(order[c0: c0 + n]))
            c0 += n
        rows: list = [None] * len(reads)
        metas = []
        for idx in calls:
            width = front_width(int(lens_np[idx].max()), self.Lmax)
            codes, _ = native.encode_batch([reads[i].seq for i in idx], width)
            for i, row in zip(idx, codes):
                rows[i] = row
            metas.append(self._front_call(codes, lens_np[idx], cov_thr[idx], vt_dis[idx]))
        meta = metas[0]
        if len(metas) > 1:
            back = torch.from_numpy(np.argsort(np.concatenate(calls)))
            if meta.is_cuda:  # a blocking upload would wait for the whole front
                back = back.pin_memory().to(meta.device, non_blocking=True)
            meta = torch.cat(metas)[back]
        self._mark("front")
        return rows, meta

    def _at_width(self, width: int) -> tuple:
        """The front's StepConfig and tables for rows ``width`` wide, made
        once a width."""
        if width not in self._widths:
            cfg = at_width(self.cfg, width)
            maps, pref, _ = _pattern_tables(cfg)
            self._widths[width] = cfg, {**self.tables,
                                        "maps": torch.from_numpy(maps).to(self.device),
                                        "pref": torch.from_numpy(pref).to(self.device)}
        return self._widths[width]

    def _front_call(self, codes, lens_np, cov_thr, vt_dis):
        """One front call on host arrays (codes [B, width]): the packed meta
        [B, ...] on the device."""
        mo = self.mo
        if self.mesh is not None:
            # pad to a multiple of the data-axis size with zero-length rows
            # (sliced off the meta below), as longread.py:272-290 does
            B, pad = len(codes), (-len(codes)) % self.mesh.shape["data"]
            codes_p = np.concatenate([codes, np.full((pad, codes.shape[1]), 255, np.uint8)])
            args = [np.concatenate([lens_np, np.zeros(pad, np.int64)]),
                    np.concatenate([cov_thr, np.zeros(pad, np.int32)]),
                    np.concatenate([vt_dis, np.ones(pad, np.int64)])]
            return self._mesh_front(*(torch.from_numpy(a).to(self.device)
                                      for a in (codes_p, *args)))[:B]
        dev = self.device
        cfg, tables = self._at_width(codes.shape[1])
        return lr_front(
            torch.from_numpy(codes).to(dev), torch.from_numpy(lens_np).to(dev),
            tables, torch.from_numpy(cov_thr).to(dev),
            torch.from_numpy(vt_dis).to(dev), cfg, k=self.mi.k,
            vt_df1=float(mo.vt_df1), vt_f=float(mo.vt_f), bw=int(mo.bw))

    def _map_device_mid(self, lens_np, results, result_idx, front, batch):
        rows, meta_dev = front
        with PROFILE.span("lr.front_wait", batch=batch):
            meta = meta_dev.cpu().numpy()
        with PROFILE.span("lr.host_mid", batch=batch):
            fallback, per_read, strands, all_jobs = self._host_mid(
                meta, rows, lens_np, results, result_idx)
        # ---- batched segment DP (bucketed), enqueued on the device ----
        with PROFILE.span("lr.dp_dispatch", batch=batch):
            ezs, pending = self._align_jobs_dispatch(all_jobs, lens_np, fallback)
        return (results, result_idx, lens_np, fallback, per_read, strands,
                all_jobs, ezs, pending)

    def _host_mid(self, meta, rows, lens_np, results, result_idx):
        """The device front's meta to segment jobs on the host: the
        filtered VtSeqs, round-2 accepts, concat graph and windows."""
        mo, mi = self.mo, self.mi
        B = len(lens_np)
        meta = unpack_lr_meta(meta, self.cfg.K)
        fallback = meta["fallback"].copy()
        lo1, hi1, lo2, hi2 = meta["lo1"], meta["hi1"], meta["lo2"], meta["hi2"]

        # ---- host: rebuild the filtered VtSeqs (filters ran on device) ----
        per_read: list = [None] * B
        for i in range(B):
            if fallback[i]:
                continue
            per_read[i] = [
                olr.VtSeq(
                    chrom_id=int(meta["k_chrom"][i, c]),
                    first_target_loc=int(meta["k_ft"][i, c]),  # signed i32
                    last_target_loc=(int(meta["k_lt"][i, c]) if meta["k_lt_adj"][i, c]
                                     else int(meta["k_lt"][i, c]) & U32),
                    first_query_loc=int(meta["k_fq"][i, c]) & U32,
                    last_query_loc=int(meta["k_lq"][i, c]),
                    str=int(meta["k_str"][i, c]),
                    score=int(meta["k_score"][i, c]),
                )
                for c in range(int(meta["kept_len"][i]))
            ]

        # ---- round-2 accepts (the scans already ran on device) ----
        if ((hi1 > lo1) | (hi2 > lo2)).any():
            vt2p = meta["vt2"]
            for (lo, hi), vt2 in (((lo1, hi1), vt2p[:, :8]), ((lo2, hi2), vt2p[:, 8:])):
                for i in range(B):
                    if fallback[i] or not per_read[i] or hi[i] <= lo[i]:
                        continue
                    cand = olr.VtSeq(
                        chrom_id=int(vt2[i, 4]) & U32,
                        first_target_loc=int(vt2[i, 5]) & U32,
                        last_target_loc=int(vt2[i, 7]) & U32,
                        first_query_loc=int(vt2[i, 1]),
                        last_query_loc=int(vt2[i, 2]),
                        str=int(vt2[i, 3]),
                        score=int(vt2[i, 0]),
                    )
                    olr.accept_round2(cand, mo, mi.k, per_read[i])

        # ---- host: concat graph + window geometry (on the -t pool) ----
        all_jobs = []  # (read i, job tuple)
        strands: list = [None] * B
        prep_idx = []
        for i in range(B):
            if fallback[i] or per_read[i] is None:
                continue
            if not per_read[i]:
                results[result_idx[i]] = []
                continue
            prep_idx.append(i)

        def _prep(i):
            seqs = per_read[i]
            olr.build_concat_graph(seqs, mo)
            qlen_sum = int(lens_np[i])
            qs_for = rows[i][:qlen_sum].astype(np.uint8)
            qs_rev = (qs_for[::-1] ^ 0x3).astype(np.uint8)
            jobs = olr.prepare_segments(self.mi.oracle_view(), mo, qs_for, qs_rev,
                                        qlen_sum, seqs)
            return (qs_for, qs_rev), jobs

        for i, (strand, jobs) in zip(prep_idx, self._map_parallel(_prep, prep_idx)):
            strands[i] = strand
            all_jobs.extend((i, job) for job in jobs)
        self._mark("host_mid")
        return fallback, per_read, strands, all_jobs

    def _map_device_tail(self, dev, batch):
        (results, result_idx, lens_np, fallback, per_read, strands,
         all_jobs, ezs, pending) = dev
        mo = self.mo
        with PROFILE.span("lr.dp_fetch", batch=batch):
            self._align_jobs_fetch(ezs, pending)
        with PROFILE.span("lr.finish", batch=batch):
            by_read: dict = {}
            for (i, job), ez in zip(all_jobs, ezs):
                jobs_i, ez_i = by_read.setdefault(i, ([], []))
                jobs_i.append(job)
                ez_i.append(ez)
            mi = self.mi.oracle_view()
            for i in range(len(lens_np)):
                if fallback[i] or not per_read[i]:
                    continue
                jobs, ez_list = by_read.get(i, ([], []))
                qs_for, qs_rev = strands[i]
                results[result_idx[i]] = lr_finish.finish_read(
                    mi, mo, qs_for, qs_rev, int(lens_np[i]), per_read[i], jobs, ez_list,
                    self.stats)
        self._mark("host_finish")
        return fallback

    # ------------------------------------------------------------------
    def _host_extd2(self, qwin, twin):
        mo = self.mo
        with PROFILE.span("lr.host_dp"):
            ez = oal.extd2(qwin, twin, mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2,
                           mo.bw, mo.zdrop, mo.end_bonus, oal.KSW_EZ_APPROX_MAX)
        return ez.score, list(ez.cigar), None

    def _align_jobs_dispatch(self, all_jobs, lens_np, fallback):
        """Per-segment DP (longread.py:439-528): exact-match short-circuit,
        then length-bucketed chunks on the device; segments beyond the
        largest bucket take the host DP. A segment's result is (score,
        cigar, row), ``row`` None where the finish fixes the CIGAR per
        record (``lr_finish.chunk_results``)."""
        mo = self.mo
        ezs: list = [None] * len(all_jobs)
        buckets: dict = {bi: [] for bi in range(len(DP_BUCKETS))}
        for n, (i, (_s, qwin, twin, exact, qlen)) in enumerate(all_jobs):
            if fallback[i]:
                ezs[n] = (oal.NEG_INF, [], None)
                continue
            if exact:
                ezs[n] = (int(lens_np[i]) * mo.a, [(int(qlen), oal.CIGAR_MATCH)], None)
                continue
            self.stats["dp_segments"] += 1
            bi = next((b for b, (lq, lt) in enumerate(DP_BUCKETS)
                       if len(qwin) <= lq and len(twin) <= lt), None)
            if bi is None:  # beyond the largest bucket (longread.py:465-470)
                ezs[n] = self._host_extd2(qwin, twin)
                self.stats["host_dp_segments"] += 1
            else:
                buckets[bi].append(n)

        pending = []
        for bi, members in buckets.items():
            if not members:
                continue
            lq, lt = DP_BUCKETS[bi]
            # bound the dirs tensor (R x N x Wd bytes) to ~1 GB per call,
            # Wd the banded window width where it engages
            T_pad = (lt + 127) // 128 * 128
            WB = window_geometry(int(mo.bw), T_pad)
            Wd = WB if WB is not None else T_pad
            R = lq + lt
            chunk = 32
            while chunk * 2 * R * Wd <= (1 << 30):
                chunk *= 2
            for c0 in range(0, len(members), chunk):
                sub = members[c0: c0 + chunk]
                # power-of-two batch: padded rows have qlen 0 (dead)
                N = 32
                while N < len(sub):
                    N <<= 1
                Q = np.zeros((N, lq), np.uint8)
                T = np.zeros((N, lt), np.uint8)
                qlens = np.zeros(N, np.int32)
                tlens = np.zeros(N, np.int32)
                for j, n in enumerate(sub):
                    _, (_s, qwin, twin, _exact, _q) = all_jobs[n]
                    Q[j, : len(qwin)] = qwin
                    T[j, : len(twin)] = twin
                    qlens[j] = len(qwin)
                    tlens[j] = len(twin)
                band = np.full(N, mo.bw, np.int32)
                # Q and T stay for the finish's rescoring of the chunk
                pending.append((sub, qlens, Q, T,
                                self._run_bucket(Q, T, qlens, tlens, band, lq, lt)))
        return ezs, pending

    def _run_bucket(self, Q, T, qlens, tlens, band, lq: int, lt: int):
        """DP + backtrack of one chunk on the device: ONE packed u8 result
        per candidate (score | fin_i | fin_j | 2-bit op stream), as
        longread.py:555-596 packs it."""
        dev = self.device
        q, t, ql, tl, bd = (torch.from_numpy(a).to(dev) for a in (Q, T, qlens, tlens, band))
        bw = int(self.mo.bw)
        params = self.cfg.params
        sd = extd2.route_state_dtype(params, lq, lt, band_budget=bw, unroll=LR_UNROLL)
        score, dirs, _, _ = extd2.extd2_batch(q, t, ql, bd, params, lq, tlens=tl,
                                              Lt=lt, band_budget=bw, unroll=LR_UNROLL,
                                              state_dtype=sd)
        self._mark("dp")
        ops, fin_i, fin_j = extd2.backtrack_band(dirs, ql, tl, bd, lq, lt,
                                                 band_budget=bw, unroll=LR_UNROLL)
        N = ops.shape[0]
        pad = (-ops.shape[1]) % 4
        if pad:
            ops = torch.cat([ops, torch.full((N, pad), 255, dtype=torch.uint8,
                                             device=dev)], 1)

        def b(x):
            return x.to(torch.int32).contiguous().view(torch.uint8).reshape(N, 4)

        packed = torch.cat([b(score), b(fin_i), b(fin_j), pack_ops(ops)], 1)
        self._mark("backtrack")
        return packed

    def _align_jobs_fetch(self, ezs, pending):
        """Fetch the DP chunks and take each to its fixed CIGARs and
        rescoring rows on the host (``lr_finish.chunk_results``), in
        dispatch order."""
        for sub, qlens, Q, T, dev in pending:
            with PROFILE.span("lr.dp_wait"):  # segment-DP D2H
                packed = dev.cpu().numpy()
            self._mark("d2h")
            n = len(sub)
            for m, res in zip(sub, lr_finish.chunk_results(packed[:n], qlens[:n], Q, T,
                                                           self.mo)):
                ezs[m] = res
            self._mark("host_finish")
        return ezs
