"""Port index vs gdiet_tpu.index: build (keys, starts, positions, codes),
the carry-across from a DietIndex and from a gdiet_tpu npz, the npz the
port writes, and the device cuckoo table answering every key."""

import numpy as np
import pytest
import torch

from gdiet_tpu.config import options_for
from gdiet_tpu.index import build_index as jax_build
from gdiet_tpu.index.build import DietIndex, lookup_vals
from gdiet_tpu.io.fastx import read_fastx
from gdiet_tpu.pipeline.device_step import pack_ref_codes as jax_pack
from gdiet_tpu_torch import u64
from gdiet_tpu_torch.index import TorchIndex, build_index
from gdiet_tpu_torch.index.build import pack_ref_codes
from gdiet_tpu_torch.pipeline.device_step import StepConfig, cuckoo_lookup
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


FIELDS = ("k", "w", "pattern", "names", "flag", "lengths", "seq_offsets",
          "codes", "keys", "starts", "positions")


def _same_index(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def _refs(data_dir, name):
    return [(r.name, r.seq) for r in read_fastx(str(data_dir / name))]


@pytest.mark.parametrize("ref,pattern", [("ref.fa", "10"), ("ref2.fa", "1110")])
def test_build_matches_jax(data_dir, ref, pattern):
    io_, _ = options_for("sr", pattern=pattern)
    refs = _refs(data_dir, ref)
    _same_index(build_index(refs, io_, "cpu"), jax_build(refs, io_))


def test_build_with_ambiguous_bases():
    rng = np.random.default_rng(4)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 40_000))
    seq = seq[:1000] + "N" * 30 + seq[1030:20_000] + "NNRN" + seq[20_004:]
    refs = [("a", seq), ("b", seq[5000:9000])]
    io_, _ = options_for("sr", pattern="10")
    mi = build_index(refs, io_, "cpu")
    _same_index(mi, jax_build(refs, io_))
    p, n = pack_ref_codes(mi.codes)
    jp, jn = jax_pack(mi.codes)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(n, jn)


def test_carry_across_and_npz(data_dir, tmp_path):
    io_, mo = options_for("sr", pattern="10")
    jmi = jax_build(_refs(data_dir, "ref.fa"), io_)
    _same_index(TorchIndex.from_numpy(jmi, "cpu"), jmi)
    path = tmp_path / "jax.gdi.npz"
    jmi.save(str(path))
    assert TorchIndex.is_index(str(path))
    _same_index(TorchIndex.from_numpy(str(path), "cpu"), jmi)
    tmi = TorchIndex.load(str(path), "cpu")
    out = tmp_path / "torch.gdi.npz"
    tmi.save(str(out))
    _same_index(DietIndex.load(str(out)), jmi)
    assert tmi.derive_mid_occ(mo) == jmi.derive_mid_occ(mo)
    for key in jmi.keys[:50]:
        np.testing.assert_array_equal(tmi.get(int(key)), jmi.get(int(key)))
    np.testing.assert_array_equal(tmi.getseq(0, 100, 260, rev=True),
                                  jmi.getseq(0, 100, 260, rev=True))


def test_cuckoo_probe_answers_every_key(data_dir):
    io_, mo = options_for("sr", pattern="10")
    mi = build_index(_refs(data_dir, "ref.fa"), io_, "cpu")
    tbl, c1, c2, nb = mi.device_cuckoo_kv()
    cfg = StepConfig.from_options(mi, mo, 1000, 160, 32, 16, 64)
    cfg = type(cfg)(**{**cfg.__dict__, "cuckoo_c1": c1, "cuckoo_c2": c2,
                       "cuckoo_nb": nb})
    keys = u64.from_numpy(mi.keys)
    s, c = cuckoo_lookup(keys, tbl, cfg)
    vals = lookup_vals(mi.starts)
    np.testing.assert_array_equal(s.numpy(), (vals >> np.uint64(24)).astype(np.int64))
    np.testing.assert_array_equal(c.numpy(), (vals & np.uint64(0xFFFFFF)).astype(np.int64))
    # absent keys (and the all-ones sentinel) are not found
    miss = torch.tensor([u64.U64_MAX, (1 << 42) + 5], dtype=torch.int64)
    s, c = cuckoo_lookup(miss, tbl, cfg)
    assert s.tolist() == [0, 0] and c.tolist() == [0, 0]


@pytest.mark.parametrize("f", [2e-4, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("dist", ["singletons", "geometric", "heavy_tail"])
def test_cal_max_occ_is_the_partition_rank(dist, f):
    """The histogram rank equals ``np.partition``'s (mm_idx_cal_max_occ),
    and a second call returns the value kept for that ``f``."""
    rng = np.random.default_rng(len(dist))
    n = 20_000
    counts = {"singletons": np.ones(n, np.int64),
              "geometric": rng.geometric(0.4, n),
              "heavy_tail": (rng.pareto(1.1, n) * 3 + 1).astype(np.int64)}[dist]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    mi = TorchIndex(k=15, w=10, pattern="10", names=["r"], lengths=np.ones(1, np.int64),
                    seq_offsets=np.zeros(1, np.int64), codes=np.zeros(1, np.uint8),
                    keys=np.arange(n, dtype=np.uint64), starts=starts,
                    positions=np.zeros(int(starts[-1]), np.uint64))
    idx = min(int((1.0 - f) * n), n - 1)
    want = int(np.partition(counts.astype(np.uint32), idx)[idx]) + 1
    assert mi.cal_max_occ(f) == want
    mi.starts = starts[:1]  # the kept value no longer reads the counts
    assert mi.cal_max_occ(f) == want
