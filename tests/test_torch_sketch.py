"""Port sketch_emit / sketch_emit_build vs gdiet_tpu.ops.sketch, bit for
bit, on seeded batches with N bases, short runs and padding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdiet_tpu import pattern as pat
from gdiet_tpu.ops import sketch as jsk
from gdiet_tpu_torch import u64
from gdiet_tpu_torch.ops import sketch as tsk
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _batch(seed, B=24, D=300):
    """diet codes [B, D] (N runs in some rows, 255 padding past the
    length), diet lengths, real positions from a pattern map, rids."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, D)).astype(np.uint8)
    for b in range(0, B, 3):
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(0, D - 5))
            codes[b, p : p + int(rng.integers(1, 5))] = 4
    codes[5, :40] = codes[5, 0]  # a homopolymer run: duplicate minimizers
    dlen = rng.integers(0, D + 1, B).astype(np.int64)
    dlen[:3] = [0, D, 17]
    for b in range(B):
        codes[b, dlen[b]:] = 255
    gm = pat.gather_map(2 * D, "110", 1)[:D]
    real = np.broadcast_to(gm, (B, D)).copy()
    rid = rng.integers(0, 5, B).astype(np.int64)
    return codes, dlen, real, rid


def _eq(ref, got, name):
    ref = np.asarray(ref)
    got = u64.to_numpy(got) if got.dtype == torch.int64 and ref.dtype == np.uint64 else got.numpy()
    np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("k,w", [(21, 11), (5, 3), (13, 7)])
@pytest.mark.parametrize("ge", [True, False])
def test_sketch_emit(k, w, ge):
    codes, dlen, real, rid = _batch(k * 10 + w)
    max_out = 64
    jr = jsk.sketch_emit(jnp.asarray(codes), jnp.asarray(dlen), jnp.asarray(real),
                         jnp.asarray(rid), k, w, max_out, final_flush_ge=ge)
    tr = tsk.sketch_emit(torch.from_numpy(codes), torch.from_numpy(dlen),
                         torch.from_numpy(real), torch.from_numpy(rid), k, w,
                         max_out, final_flush_ge=ge)
    for name, a, b in zip(("xs", "ys", "valid", "n"), jr, tr):
        _eq(a, b, name)
    assert int(np.asarray(jr[3]).max()) > 0


@pytest.mark.parametrize("pattern", ["10", "1110"])
def test_sketch_emit_build(pattern):
    k, w = 21, 11
    codes, dlen, _, rid = _batch(3, B=8, D=512)
    lo = np.array([0, 5, 1000, 17, 3, 0, 250, 9], np.int64)
    ones = pat.ones_locations(pattern)
    for ge in (True, False):
        jxy, jn = jsk.sketch_emit_build(
            jnp.asarray(codes), jnp.asarray(dlen), jnp.asarray(lo),
            jnp.asarray(rid), k, w, 128, ones, len(pattern), final_flush_ge=ge)
        txy, tn = tsk.sketch_emit_build(
            torch.from_numpy(codes), torch.from_numpy(dlen), torch.from_numpy(lo),
            torch.from_numpy(rid), k, w, 128, ones, len(pattern), final_flush_ge=ge)
        _eq(jxy, txy, "xy")
        _eq(jn, tn, "n")


def test_hash64():
    rng = np.random.default_rng(11)
    for k in (5, 15, 21):
        mask = (1 << (2 * k)) - 1
        keys = rng.integers(0, mask + 1, 2048, dtype=np.uint64)
        ref = np.asarray(jsk.hash64(jnp.asarray(keys), jnp.uint64(mask)))
        got = tsk.hash64(u64.from_numpy(keys), mask)
        np.testing.assert_array_equal(u64.to_numpy(got), ref)
