"""Bucketed cuckoo hash probe table for the device index lookup.

The CSR lookup (mm_idx_get, index.c:84-100) on device was a bucketed
binary search: ~4-6 DEPENDENT random gathers per probe — a serial chain of
HBM round trips that dominates collect_hits. A 2-side bucketed cuckoo hash
answers every probe with 4 row gathers in 2 INDEPENDENT rounds
(side-1 keys/vals ∥ side-2 keys/vals), cutting both element count and,
more importantly, the serial depth.

Layout: per side, ``n_buckets`` buckets of 4 (key, val) slots; side 1's
buckets start at flat slot ``4 * n_buckets``. Keys are the 2k-bit
invertible minimizer hashes (sketch.c:25-34 analog); values are the packed
CSR (start << 24 | count) from index.build.lookup_vals. Bucket addressing
is a fixed-point range map ``((q*c) >> 32) * n_buckets >> 32`` — NO
power-of-two rounding, so the table is sized to the key count exactly:
4-slot buckets run safely at ~0.85 load, giving ~1.2x the packed CSR
key+val bytes (at GRCh38 scale, ~250 M keys, about 4.7 GB HBM — a
power-of-two 1-slot table would need 17 GB and overflow the chip).
A probe reads whole buckets (32 B contiguous), which costs the same HBM
round trip as the old single-slot gather.

Build is a vectorized parallel random-walk eviction (numpy): each round
the unplaced keys claim the first free slot of their bucket on one side
(last write per slot wins), full-bucket keys evict a rotating victim slot;
losers and evicted occupants retry on the other side next round. Converges
w.h.p. in O(log n) rounds at 4-slot loads well below ~0.98; on a cycle the
build retries with fresh hash constants.

The table holds each key MIXED (``u64.fmix64``: MurmurHash3's 64-bit
finalizer, a bijection), and a probe mixes its query the same way
(``device_step.cuckoo_lookup``, ``probe_host``). The range map alone
fails on keys of 32 bits or fewer (k <= 16): the top 32 bits of
``q * c1`` then fix those of ``q * c2``, so the two sides' buckets are
tied, and a 2k = 30-bit index of ~20 M keys or more (the map-ont preset's
k 15 on 300 Mbp) cannot be placed at any of the four hash-constant pairs.
Mixed keys are spread over all 64 bits first. A bijection keeps equality
exact and the values are unchanged; the one key whose mix is ``EMPTY`` is
over 2**63, no minimizer key (at most 2k = 56 bits). This differs from
``gdiet_tpu``'s table, which places the raw keys.
"""

from __future__ import annotations

import numpy as np

from gdiet_tpu_torch import u64
from gdiet_tpu_torch.utils.profile import PROFILE

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
SLOTS = 4  # slots per bucket (one 32-byte key row per probe side)

# odd 64-bit multiplicative constants (splitmix64 / Fibonacci-style)
_DEFAULT_C = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)
_RETRY_C = (
    (0x94D049BB133111EB, 0x2545F4914F6CDD1D),
    (0xD6E8FEB86659FD93, 0xA5A5A5A5A5A5A5A7),
    (0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9),
)


def _bucket(keys: np.ndarray, c: int, n_buckets: int) -> np.ndarray:
    """Range-mapped bucket id in [0, n_buckets): fixed-point multiply of
    the top 32 hash bits — uniform without power-of-two table sizes."""
    t = (keys * np.uint64(c)) >> np.uint64(32)
    return ((t * np.uint64(n_buckets)) >> np.uint64(32)).astype(np.int64)


def build_cuckoo(keys: np.ndarray, vals: np.ndarray, max_rounds: int = 512,
                 load: float = 0.85):
    """Place (keys, vals) into a 2-side, 4-slot-bucket cuckoo table.

    Returns (tbl_keys [2*NB*4] u64, the keys mixed by ``u64.fmix64``;
    tbl_vals [2*NB*4] u64, c1, c2, n_buckets-per-side NB). The build is the
    span ``index.cuckoo_build`` (its ``keys`` and the hash-constant pairs
    it tried, ``attempts``).
    """
    with PROFILE.span("index.cuckoo_build", keys=len(keys)) as sp:
        return _build(u64.to_numpy(u64.fmix64(u64.from_numpy(keys))),
                      np.ascontiguousarray(vals, np.uint64),
                      max_rounds, load, sp)


def _build(keys, vals, max_rounds, load, sp):
    nk = len(keys)
    if (keys == EMPTY).any():
        raise ValueError("a key mixes to the table's EMPTY sentinel")
    # total slots = 2 * NB * SLOTS ~= nk / load
    NB = max(1, int(np.ceil(nk / (2 * SLOTS * load))) if nk else 1)

    # native sequential insertion: O(1) amortized per key — at GRCh38 scale
    # (250M keys) the vectorized numpy walk below would take >1 h, the C
    # build ~1 min. Same layout; any valid placement probes identically.
    from gdiet_tpu_torch import native

    if native.lib is not None:
        import ctypes

        for attempt, (c1, c2) in enumerate((_DEFAULT_C, *_RETRY_C), 1):
            if sp is not None:
                sp.attrs["attempts"] = attempt
            tbl_k = np.full(2 * NB * SLOTS, EMPTY, np.uint64)
            tbl_v = np.zeros(2 * NB * SLOTS, np.uint64)
            ok = native.lib.cuckoo_build_c(
                native._ptr(keys, ctypes.c_uint64),
                native._ptr(vals, ctypes.c_uint64), nk,
                native._ptr(tbl_k, ctypes.c_uint64),
                native._ptr(tbl_v, ctypes.c_uint64),
                NB, c1, c2, 500,
            )
            if ok:
                return tbl_k, tbl_v, c1, c2, NB
        raise RuntimeError(
            f"cuckoo build failed for {nk} keys at NB={NB} "
            "(all hash-constant retries exhausted)"
        )

    for attempt, (c1, c2) in enumerate((_DEFAULT_C, *_RETRY_C), 1):
        if sp is not None:
            sp.attrs["attempts"] = attempt
        tbl_k = np.full(2 * NB * SLOTS, EMPTY, np.uint64)
        tbl_v = np.zeros(2 * NB * SLOTS, np.uint64)
        k2 = tbl_k.reshape(-1, SLOTS)
        cur_k, cur_v = keys, vals
        side = 0
        ok = False
        for r in range(max_rounds):
            if len(cur_k) == 0:
                ok = True
                break
            b = _bucket(cur_k, c1 if side == 0 else c2, NB) + side * NB
            rows = k2[b]  # [n, SLOTS]
            free = rows == EMPTY
            has_free = free.any(axis=1)
            first_free = free.argmax(axis=1)
            # full buckets evict a rotating victim slot (random walk)
            victim = ((cur_k >> np.uint64(17)).astype(np.int64) + r) % SLOTS
            slot = b * SLOTS + np.where(has_free, first_free, victim)
            old_k = tbl_k[slot]
            old_v = tbl_v[slot]
            tbl_k[slot] = cur_k  # last write per slot wins
            tbl_v[slot] = cur_v
            won = tbl_k[slot] == cur_k
            # winners are unique per slot, so their gathered old occupants
            # are each evicted exactly once
            ev = old_k[won]
            evv = old_v[won]
            live = ev != EMPTY
            cur_k = np.concatenate([cur_k[~won], ev[live]])
            cur_v = np.concatenate([cur_v[~won], evv[live]])
            side ^= 1
        if ok:
            return tbl_k, tbl_v, c1, c2, NB
    raise RuntimeError(
        f"cuckoo build failed for {nk} keys at NB={NB} "
        "(all hash-constant retries exhausted)"
    )


def probe_host(tbl_k, tbl_v, c1, c2, n_buckets, q):
    """Reference host-side probe (for tests) of the raw keys ``q``."""
    q = u64.to_numpy(u64.fmix64(u64.from_numpy(q)))
    k2 = tbl_k.reshape(-1, SLOTS)
    v2 = tbl_v.reshape(-1, SLOTS)
    out = np.zeros(len(q), np.uint64)
    found = np.zeros(len(q), bool)
    for side, c in ((0, c1), (1, c2)):
        b = _bucket(q, c, n_buckets) + side * n_buckets
        m = k2[b] == q[:, None]  # [n, SLOTS]; keys unique -> <=1 match
        hit = m.any(axis=1)
        # exact select: sum of matched vals (at most one match per row)
        out = np.where(hit & ~found, (v2[b] * m).sum(axis=1, dtype=np.uint64), out)
        found |= hit
    return out, found
