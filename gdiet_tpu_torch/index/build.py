"""Diet minimizer index for the port: holder, device tables, build.

Counterpart of ``gdiet_tpu/index/build.py``. ``TorchIndex`` holds the same
numpy fields as ``DietIndex`` (sorted unique keys, CSR starts, packed
positions, nt4 reference codes) and reads and writes the same npz format,
so an index saved by either package loads in the other. Device tensors are
built for an explicit ``device``: the merged-row cuckoo probe table and the
2-bit packed reference with its N mask.

``build_index`` sketches each sequence with the port's ``sketch_emit_build``
on the index's device and sorts the minimizers with the native radix sort;
``build_index_parts`` builds the parts of a split index (``-I``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from gdiet_tpu_torch import config, native, pattern as pat, u64
from gdiet_tpu_torch.index.cuckoo import build_cuckoo
from gdiet_tpu_torch.oracle.sketch import seq_to_code
from gdiet_tpu_torch.ops.sketch import sketch_emit_build

CHUNK = 1 << 14  # diet positions per row
GROUP = 64  # rows per device call
MAGIC = "GDI\x01"


def lookup_vals(starts) -> np.ndarray:
    """Packed per-key (start << 24 | count) values, counts saturating at
    2^24-1 (gdiet_tpu/index/build.py:275-282)."""
    s = np.asarray(starts, np.uint64)
    cnt = np.minimum(s[1:] - s[:-1], 0xFFFFFF).astype(np.uint64)
    return (s[:-1] << np.uint64(24)) | cnt


def bucket_table(keys: np.ndarray, k: int, max_bits: int = 22):
    """Direct-address bucket index over the sorted key array
    (gdiet_tpu/index/build.py:285-303): bucket j, the top ``b`` bits of the
    2k-bit hash, covers the keys in [table[j], table[j+1]). Returns (table
    [2^b+1] int64, shift, iters), ``iters`` the binary-search depth that
    covers the largest bucket."""
    nk = len(keys)
    b = max(8, int(np.ceil(np.log2(nk))) + 2) if nk else 8
    b = min(max_bits, 2 * k, b)
    shift = max(2 * k - b, 0)
    bounds = np.arange((1 << b) + 1, dtype=np.uint64) << np.uint64(shift)
    tbl = np.searchsorted(keys, bounds).astype(np.int64)
    maxb = int(np.max(np.diff(tbl))) if nk else 0
    iters = max(1, int(np.ceil(np.log2(maxb + 1))) + 1)
    return tbl, shift, iters


def pack_ref_codes(codes: np.ndarray):
    """2-bit pack of nt4 reference codes plus a 1-bit N mask (None when the
    genome has no N), as gdiet_tpu/pipeline/device_step.py:1080 packs them."""
    codes = np.asarray(codes, np.uint8)
    L = len(codes)
    pad = (-L) % 4
    c = (codes & 3).astype(np.uint8)
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
    packed = c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | (c[3::4] << 6)
    nmask = None
    if bool((codes > 3).any()):
        n = (codes > 3).astype(np.uint8)
        padn = (-L) % 8
        if padn:
            n = np.concatenate([n, np.zeros(padn, np.uint8)])
        nmask = np.packbits(n.reshape(-1, 8), axis=1, bitorder="little").ravel()
    return packed.astype(np.uint8), nmask


@dataclass
class TorchIndex:
    k: int
    w: int
    pattern: str
    names: list
    lengths: np.ndarray  # [n_seq] int64
    seq_offsets: np.ndarray  # [n_seq] int64
    codes: np.ndarray  # [total_len] uint8 nt4 (4 = N)
    keys: np.ndarray  # [K] uint64 sorted unique
    starts: np.ndarray  # [K+1] int64
    positions: np.ndarray  # [P] uint64
    flag: int = 0
    device: torch.device = torch.device("cpu")
    _dev: dict = field(default_factory=dict, repr=False)

    FIELDS = ("k", "w", "pattern", "names", "lengths", "seq_offsets", "codes",
              "keys", "starts", "positions", "flag")

    @classmethod
    def from_numpy(cls, fields, device) -> "TorchIndex":
        """Carry an index across from ``gdiet_tpu``: ``fields`` is a
        ``DietIndex`` (or any object or dict with its numpy fields), or the
        path of an npz that ``DietIndex.save`` wrote."""
        if isinstance(fields, (str, bytes)) or hasattr(fields, "__fspath__"):
            return cls.load(fields, device)
        get = fields.get if isinstance(fields, dict) else (
            lambda n: getattr(fields, n))
        return cls(**{n: get(n) for n in cls.FIELDS}, device=torch.device(device))

    @property
    def n_seq(self) -> int:
        return len(self.names)

    # ---- host queries (the oracle fallback reads these) -------------------
    def get(self, minier: int) -> np.ndarray:
        """mm_idx_get (index.c:84-100)."""
        i = np.searchsorted(self.keys, np.uint64(minier))
        if i < len(self.keys) and self.keys[i] == np.uint64(minier):
            return self.positions[self.starts[i] : self.starts[i + 1]]
        return np.zeros((0,), dtype=np.uint64)

    def getseq(self, rid: int, st: int, en: int, rev: bool = False) -> np.ndarray:
        """mm_idx_getseq2 (index.c:157-188)."""
        off = int(self.seq_offsets[rid])
        ln = int(self.lengths[rid])
        en = min(en, ln)
        if not rev:
            return self.codes[off + st : off + en].copy()
        frag = self.codes[off + ln - en : off + ln - st][::-1]
        return np.where(frag < 4, 3 - frag, frag).astype(np.uint8)

    def oracle_view(self):
        """The index as the scalar oracle reads it (w, k, pattern, names,
        lengths as Python ints, get, getseq), made once."""
        if "oracle" not in self._dev:
            mi = self

            class _View:
                w, k, pattern = mi.w, mi.k, mi.pattern
                names, lengths = mi.names, [int(x) for x in mi.lengths]
                get, getseq = staticmethod(mi.get), staticmethod(mi.getseq)

            self._dev["oracle"] = _View()
        return self._dev["oracle"]

    def cal_max_occ(self, f: float) -> int:
        """mm_idx_cal_max_occ (index.c:190-210)."""
        if f <= 0.0 or len(self.keys) == 0:
            return 2**31 - 1
        counts = (self.starts[1:] - self.starts[:-1]).astype(np.uint32)
        n = len(counts)
        idx = min(int((1.0 - f) * n), n - 1)
        return int(np.partition(counts, idx)[idx]) + 1

    def derive_mid_occ(self, mo) -> int:
        """mm_mapopt_update (options.c:64-76)."""
        if mo.mid_occ > 0:
            return mo.mid_occ
        mid = max(self.cal_max_occ(mo.mid_occ_frac), mo.min_mid_occ)
        if mo.max_mid_occ > mo.min_mid_occ:
            mid = min(mid, mo.max_mid_occ)
        return mid

    def stats(self) -> dict:
        """mm_idx_stat (index.c:102-127), as gdiet_tpu/index/build.py:182-196."""
        counts = self.starts[1:] - self.starts[:-1]
        n = len(self.keys)
        total = int(self.lengths.sum())
        return {
            "kmer_size": self.k,
            "skip": self.w,
            "n_seq": self.n_seq,
            "distinct_minimizers": n,
            "pct_singletons": 100.0 * float((counts == 1).sum()) / n if n else 0.0,
            "avg_occurrences": float(counts.mean()) if n else 0.0,
            "avg_spacing": total / float(counts.sum()) if n else 0.0,
            "total_length": total,
        }

    # ---- device tables ----------------------------------------------------
    def device_cuckoo_kv(self):
        """Cuckoo probe table over (keys, packed CSR values) on the device,
        bucket-major with each bucket's (k0..k3, v0..v3) contiguous — the
        layout of gdiet_tpu's [rows, 128] table, kept flat, so that a probe
        gathers its bucket's 8 words directly. Returns (table [2*NB*8]
        int64 bit patterns, c1, c2, NB)."""
        if "cuckoo_kv" not in self._dev:
            tk, tv, c1, c2, nb = build_cuckoo(
                self.keys, lookup_vals(self.starts))
            kv = np.concatenate(
                [np.asarray(tk).reshape(-1, 4), np.asarray(tv).reshape(-1, 4)],
                axis=1).ravel()
            self._dev["cuckoo_kv"] = (u64.from_numpy(kv, self.device), c1, c2, nb)
        return self._dev["cuckoo_kv"]

    def device_packed(self):
        """(2-bit packed reference u8, N mask u8 or None) on the device."""
        if "packed" not in self._dev:
            packed, nmask = pack_ref_codes(self.codes)
            self._dev["packed"] = (
                torch.from_numpy(packed).to(self.device),
                None if nmask is None else torch.from_numpy(nmask).to(self.device),
            )
        return self._dev["packed"]

    def device_positions(self) -> torch.Tensor:
        if "positions" not in self._dev:
            self._dev["positions"] = u64.from_numpy(self.positions, self.device)
        return self._dev["positions"]

    # ---- npz format of DietIndex.save/load (index/build.py:199-263) ------
    def save(self, path: str):
        meta = {"magic": MAGIC, "k": self.k, "w": self.w,
                "pattern": self.pattern, "flag": self.flag,
                "names": list(self.names), "codes_len": int(len(self.codes))}
        packed, nmask = pack_ref_codes(self.codes)
        np.savez(
            path, meta=json.dumps(meta), lengths=self.lengths,
            seq_offsets=self.seq_offsets, codes_packed=packed,
            codes_nmask=nmask if nmask is not None else np.zeros(0, np.uint8),
            keys=self.keys, starts=self.starts, positions=self.positions,
        )

    @classmethod
    def load(cls, path, device) -> "TorchIndex":
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        if meta.get("magic") != MAGIC:
            raise ValueError(f"{path}: not a gdiet index")
        if "codes" in z.files:  # pre-pack format
            codes = z["codes"]
        else:
            packed = z["codes_packed"]
            codes = np.zeros(len(packed) * 4, np.uint8)
            for t in range(4):
                codes[t::4] = (packed >> (2 * t)) & 3
            nmask = z["codes_nmask"]
            if len(nmask):
                bits = np.unpackbits(nmask, bitorder="little")[: len(codes)]
                codes[bits.astype(bool)] = 4
            codes = codes[: meta["codes_len"]]
        return cls(
            k=meta["k"], w=meta["w"], pattern=meta["pattern"],
            flag=meta["flag"], names=list(meta["names"]),
            lengths=z["lengths"], seq_offsets=z["seq_offsets"], codes=codes,
            keys=z["keys"], starts=z["starts"], positions=z["positions"],
            device=torch.device(device),
        )

    @staticmethod
    def is_index(path: str) -> bool:
        """mm_idx_is_idx (index.c:573-593)."""
        try:
            z = np.load(path, allow_pickle=False)
            return json.loads(str(z["meta"])).get("magic") == MAGIC
        except (OSError, ValueError, KeyError):
            return False


def _sketch_sequence(codes: np.ndarray, k: int, w: int, pattern: str,
                     rid: int, device) -> tuple[np.ndarray, np.ndarray]:
    """Sketch one sequence as rows of CHUNK diet positions with (2w+k)
    overlap on ``device`` (gdiet_tpu/index/build.py:305-439, one
    synchronous call per group). The true sequence end needs the strict
    final-flush rule and runs as its own row; each row keeps only the
    minimizers it owns. Returns (keys, ys) numpy uint64, unordered."""
    dcodes = pat.diet_codes(codes, pattern, 0)
    D = len(dcodes)
    if D == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    ones_loc = pat.ones_locations(pattern)
    plen = len(pattern)
    ov = 2 * w + k
    width = CHUNK + 2 * ov
    row_starts = list(range(0, D, CHUNK))
    max_out = int(min(width, 4 * width // (w + 1) + 64))
    keys_out, ys_out = [], []

    def run(rows, flush_ge, budget):
        G = len(rows)
        dc = np.full((G, width), 255, np.uint8)
        ns = np.zeros(G, np.int64)
        los = np.zeros(G, np.int64)
        bounds = []
        for g, (st, en) in enumerate(rows):
            lo, hi = max(0, st - ov), min(D, en + ov)
            bounds.append((st, en))
            dc[g, : hi - lo] = dcodes[lo:hi]
            ns[g] = hi - lo
            los[g] = lo
        xy, cnt = sketch_emit_build(
            torch.from_numpy(dc).to(device), torch.from_numpy(ns).to(device),
            torch.from_numpy(los).to(device),
            torch.full((G,), rid, dtype=torch.int64, device=device),
            k, w, budget, ones_loc, plen, final_flush_ge=flush_ge,
        )
        cnt = cnt.cpu().numpy()
        if budget < width and int(cnt.max(initial=0)) > budget:
            run(rows, flush_ge, width)  # rare duplicate storm: full width
            return
        xy = u64.to_numpy(xy)
        xs, ys = xy[:, :budget], xy[:, budget:]
        for g, (st, en) in enumerate(bounds):
            m = int(cnt[g])
            xg, yg = xs[g, :m], ys[g, :m]
            p_real = ((yg & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
            p_diet = pat.diet_location(p_real, pattern, 0)
            own = (p_diet >= st) & (p_diet < en)
            keys_out.append(xg[own] >> np.uint64(8))
            ys_out.append(yg[own])

    interior = [(st, min(st + CHUNK, D)) for st in row_starts[:-1]]
    for i in range(0, len(interior), GROUP):
        run(interior[i : i + GROUP], True, max_out)
    run([(row_starts[-1], D)], False, max_out)
    return np.concatenate(keys_out), np.concatenate(ys_out)


def build_index(seqs, io, device) -> TorchIndex:
    """mm_idx_gen analog: sketch every sequence on ``device``, then build
    the CSR arrays on the host (gdiet_tpu/index/build.py:463-541).
    ``seqs`` is an iterable of (name, seq) or a dict."""
    native.require_native()
    no_seq = bool(io.flag & config.MM_I_NO_SEQ)
    items = seqs.items() if isinstance(seqs, dict) else seqs
    names, lengths, offsets, codes_all, all_keys, all_ys = [], [], [], [], [], []
    off = 0
    for rid, (name, seq) in enumerate(items):
        codes = seq_to_code(seq) if isinstance(seq, (str, bytes)) else seq
        names.append(name)
        lengths.append(len(codes))
        offsets.append(off)
        off += len(codes)
        if not no_seq:
            codes_all.append(codes)
        ks, ys = _sketch_sequence(codes, io.k, io.w, io.pattern, rid, device)
        all_keys.append(ks)
        all_ys.append(ys)
    keys = np.concatenate(all_keys) if all_keys else np.zeros(0, np.uint64)
    ys = np.concatenate(all_ys) if all_ys else np.zeros(0, np.uint64)
    keys = np.ascontiguousarray(keys, np.uint64)
    ys = np.ascontiguousarray(ys, np.uint64)
    # emission order is position-monotonic per sequence and rids ascend,
    # so ys is usually sorted already and the radix skips its value passes
    presorted = len(ys) < 2 or bool(np.all(ys[1:] >= ys[:-1]))
    native.radix_sort_kv(keys, ys, vals_presorted=presorted)
    if len(keys):
        bound = np.empty(len(keys), bool)
        bound[0] = True
        np.not_equal(keys[1:], keys[:-1], out=bound[1:])
        start_idx = np.flatnonzero(bound)
        uniq = keys[start_idx]
    else:
        uniq, start_idx = keys, np.zeros(0, np.int64)
    starts = np.concatenate([start_idx.astype(np.int64), [len(ys)]])
    return TorchIndex(
        k=io.k, w=io.w, pattern=io.pattern, names=names,
        lengths=np.array(lengths, np.int64),
        seq_offsets=np.array(offsets, np.int64),
        codes=np.concatenate(codes_all) if codes_all else np.zeros(0, np.uint8),
        keys=uniq, starts=starts, positions=ys, flag=io.flag,
        device=torch.device(device),
    )


def build_index_parts(seqs, io, device):
    """Multi-part indexing (mm_idx_reader_read with -I batch_size,
    index.c:624-640; gdiet_tpu/index/build.py:442-460): sequences
    accumulate into parts of ~batch_size bases, each built on ``device``.
    Yields (TorchIndex, rid_shift) per part."""
    part: list = []
    total = 0
    shift = 0
    for name, seq in seqs:
        part.append((name, seq))
        total += len(seq)
        if total >= io.batch_size:
            yield build_index(part, io, device), shift
            shift += len(part)
            part, total = [], 0
    if part:
        yield build_index(part, io, device), shift
