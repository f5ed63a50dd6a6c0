"""uint64-in-int64 helpers of the port vs numpy uint64, including values
with bit 63 set and the cuckoo range map of index/cuckoo.py."""

import numpy as np
import pytest
import torch

from gdiet_tpu.index.cuckoo import _DEFAULT_C, _RETRY_C, _bucket
from gdiet_tpu_torch import u64


def _values(seed, n=4096):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    edge = np.array([0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1,
                     2**64 - 2, 2**64 - 1], np.uint64)
    return np.concatenate([v, edge, v >> np.uint64(13)])


def test_roundtrip_and_constants():
    a = _values(1)
    t = u64.from_numpy(a)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(u64.to_numpy(t), a)
    assert u64.as_i64(0xFFFFFFFFFFFFFFFF) == u64.U64_MAX
    assert u64.as_i64(1 << 63) == u64.SIGN
    assert u64.as_i64(12345) == 12345


@pytest.mark.parametrize("s", [0, 1, 8, 24, 32, 63])
def test_logical_shift(s):
    a = _values(2)
    np.testing.assert_array_equal(u64.to_numpy(u64.srl(u64.from_numpy(a), s)),
                                  a >> np.uint64(s))


def test_unsigned_order():
    a, b = _values(3), _values(4)
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    np.testing.assert_array_equal(u64.ule(ta, tb).numpy(), a <= b)
    np.testing.assert_array_equal((u64.ordered(ta) < u64.ordered(tb)).numpy(), a < b)
    perm = u64.argsort_u64(ta)
    np.testing.assert_array_equal(u64.to_numpy(ta[perm]), np.sort(a))
    np.testing.assert_array_equal(perm.numpy(), np.argsort(a, kind="stable"))
    # U64_MAX sorts last, after every value with bit 63 set
    assert u64.to_numpy(ta[perm])[-1] == np.uint64(2**64 - 1)


def test_wrapping_arithmetic():
    a, b = _values(5), _values(6)
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    with np.errstate(over="ignore"):
        for op in (np.add, np.subtract, np.multiply):
            got = {np.add: ta + tb, np.subtract: ta - tb, np.multiply: ta * tb}[op]
            np.testing.assert_array_equal(u64.to_numpy(got), op(a, b))
    np.testing.assert_array_equal(u64.to_numpy(ta << 21), a << np.uint64(21))
    np.testing.assert_array_equal(u64.to_numpy(~ta), ~a)


@pytest.mark.parametrize("c", [*_DEFAULT_C, *(c for pair in _RETRY_C for c in pair)])
@pytest.mark.parametrize("nb", [1, 7, 4096, 123_456_789])
def test_cuckoo_range_map(c, nb):
    q = _values(7) & np.uint64((1 << 42) - 1)  # 2k-bit minimizer keys
    q = np.concatenate([q, _values(8)])  # and arbitrary bits
    np.testing.assert_array_equal(u64.range_map(u64.from_numpy(q), c, nb).numpy(),
                                  _bucket(q, c, nb))
