"""The port's cuckoo probe table (``index/cuckoo.py``) on key sets of every
width the presets give, on the CPU.

- The table is built and probed on keys mixed by ``u64.fmix64``: a 2k =
  30-bit set of 18 M random keys (the map-ont preset's k 15; the size at
  which the raw range map first fails, as on a 300 Mbp genome's ~25 M
  keys) and a 22-bit set of 1 M (which the raw map cannot place at any
  of its hash-constant pairs) now build at the first pair, as do 34-,
  38- (k 19) and 42-bit (k 21) sets.
- The table holds every key, mixed, with its value; ``probe_host`` (on
  every key of a set of up to 2 M, a sample of 2 M beyond) and
  ``device_step.cuckoo_lookup`` (plain torch, 200 k) find keys with their
  values and miss absent keys.
- The build is the span ``index.cuckoo_build`` with its ``keys`` and
  ``attempts``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from gdiet_tpu_torch import u64
from gdiet_tpu_torch.index import cuckoo
from gdiet_tpu_torch.pipeline.device_step import cuckoo_lookup
from gdiet_tpu_torch.testing import torch_threads
from gdiet_tpu_torch.utils.profile import PROFILE

M64 = (1 << 64) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _keys(bits: int, n: int, seed: int = 1) -> np.ndarray:
    """n distinct random keys of ``bits`` bits, in random order."""
    g = np.random.default_rng(seed)
    k = np.zeros(0, np.uint64)
    while len(k) < n:
        k = np.unique(np.concatenate(
            [k, g.integers(0, 1 << bits, n - len(k) + n // 50 + 16, dtype=np.uint64)]))
    return g.permutation(k)[:n]


def _absent(keys: np.ndarray, bits: int, n: int) -> np.ndarray:
    g = np.random.default_rng(99)
    q = g.integers(0, 1 << bits, 4 * n, dtype=np.uint64)
    return np.concatenate([np.setdiff1d(q, keys)[:n], [cuckoo.EMPTY]]).astype(np.uint64)


def _mix(keys: np.ndarray) -> np.ndarray:
    return u64.to_numpy(u64.fmix64(u64.from_numpy(keys)))


def _lookup(tk, tv, c1, c2, nb, q):
    """(start, count) of ``device_step.cuckoo_lookup`` on the table laid
    out as ``TorchIndex.device_cuckoo_kv`` lays it out."""
    kv = np.concatenate([tk.reshape(-1, 4), tv.reshape(-1, 4)], axis=1).ravel()
    cfg = SimpleNamespace(cuckoo_c1=c1, cuckoo_c2=c2, cuckoo_nb=nb)  # all it reads
    s, c = cuckoo_lookup(u64.from_numpy(q), u64.from_numpy(kv), cfg)
    return s.numpy(), c.numpy()


@pytest.mark.parametrize("bits,n", [(30, 18_000_000), (22, 1_000_000), (34, 500_000),
                                    (38, 2_000_000), (42, 300_000)])
def test_table_builds_and_answers_every_key(bits, n):
    keys = _keys(bits, n)
    # packed CSR values (start << 24 | count), as index.build.lookup_vals
    g = np.random.default_rng(bits)
    vals = (g.integers(0, 1 << 38, n, dtype=np.uint64) << np.uint64(24)) | \
        g.integers(1, 1 << 24, n, dtype=np.uint64)
    PROFILE.enabled = True
    try:
        tk, tv, c1, c2, nb = cuckoo.build_cuckoo(keys, vals)
    finally:
        PROFILE.enabled = False
        spans = [s for s in PROFILE.intervals if s.name == "index.cuckoo_build"]
        PROFILE.reset()
    # placed at the first hash-constant pair
    assert [s.attrs for s in spans] == [{"keys": n, "attempts": 1}]
    assert 2 * nb * cuckoo.SLOTS * 0.85 == pytest.approx(n, rel=1e-5, abs=8)
    # the table holds every key, mixed, with its value, and nothing else
    full = tk != cuckoo.EMPTY
    assert int(full.sum()) == n
    mixed = _mix(keys)
    o, w = np.argsort(tk[full]), np.argsort(mixed)
    np.testing.assert_array_equal(tk[full][o], mixed[w])
    np.testing.assert_array_equal(tv[full][o], vals[w])
    # the host probe on every key up to 2 M (a sample beyond: it takes
    # ~0.7 us a key), the plain-torch probe on 200 k (its [n, 8] gathers)
    g = np.random.default_rng(5)
    pick = g.choice(n, min(n, 2_000_000), replace=False)
    got, found = cuckoo.probe_host(tk, tv, c1, c2, nb, keys[pick])
    assert found.all()
    np.testing.assert_array_equal(got, vals[pick])
    miss = _absent(keys, bits, 1000)
    _, found = cuckoo.probe_host(tk, tv, c1, c2, nb, miss)
    assert not found.any()
    pick = pick[:200_000]
    s, c = _lookup(tk, tv, c1, c2, nb, np.concatenate([keys[pick], miss]))
    np.testing.assert_array_equal(s[:len(pick)], (vals[pick] >> np.uint64(24)).astype(np.int64))
    np.testing.assert_array_equal(c[:len(pick)], (vals[pick] & np.uint64(0xFFFFFF)).astype(np.int64))
    assert not s[len(pick):].any() and not c[len(pick):].any()


def _unmix(x: int) -> int:
    """The inverse of ``u64.fmix64`` on one Python int."""
    for c in reversed(u64.FMIX_C):
        x ^= x >> 33
        x = (x * pow(c, -1, 1 << 64)) & M64
    return x ^ (x >> 33)


def test_mix_is_a_bijection():
    g = np.random.default_rng(3)
    x = np.concatenate([g.integers(0, 1 << 63, 5000, dtype=np.uint64) * np.uint64(2) + np.uint64(1),
                        g.integers(0, 1 << 30, 5000, dtype=np.uint64),
                        np.array([0, 1, M64, 1 << 63], np.uint64)])
    h = _mix(x)
    assert [_unmix(int(v)) for v in h] == [int(v) for v in x]
    assert len(np.unique(h)) == len(np.unique(x))
    # the one key that mixes to EMPTY is no 2k-bit minimizer key (k <= 28)
    # and not the query sentinel U64_MAX
    pre = _unmix(M64)
    assert _mix(np.array([pre], np.uint64))[0] == cuckoo.EMPTY
    assert pre >= 1 << 56 and pre != M64
