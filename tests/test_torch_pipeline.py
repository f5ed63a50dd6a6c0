"""Port ShortReadMapper on the CPU vs the reference binary's golden SAM.

The port maps through ``map_stream_sam`` (device step on the CPU with the
plain DP, native C finish) and must reproduce the golden records byte for
byte. One case squeezes the budgets so that the retry tier and the scalar
oracle both take reads, and the SAM must still be identical.
"""

import pytest

from gdiet_tpu_torch.config import options_for
from gdiet_tpu_torch.io.fastx import read_fastx
from gdiet_tpu_torch.index import build_index
from gdiet_tpu_torch.ops import dp
from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _options(pattern):
    return options_for(
        "sr", pattern=pattern, max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2,
    )


def _golden(path):
    return [l for l in path.read_text().splitlines() if not l.startswith("@")]


def _map(data_dir, ref, reads, pattern, **kw):
    io_, mo = _options(pattern)
    mi = build_index([(r.name, r.seq) for r in read_fastx(str(data_dir / ref))],
                     io_, "cpu")
    mapper = ShortReadMapper(mi, mo, device="cpu", **kw)
    recs = list(read_fastx(str(data_dir / reads)))
    sam = b"".join(bytes(b) for b in mapper.map_stream_sam(iter([recs])))
    return sam.decode().splitlines(), mapper


@pytest.mark.parametrize("ref,reads,golden,pattern,lmax", [
    ("ref.fa", "reads.fq", "golden.sam", "10", 256),
    ("ref2.fa", "reads2.fq", "golden2_10.sam", "10", 512),
])
def test_golden(data_dir, ref, reads, golden, pattern, lmax):
    calls0 = dp.calls.n
    lines, mapper = _map(data_dir, ref, reads, pattern, max_read_len=lmax)
    assert lines == _golden(data_dir / golden)
    assert dp.calls.n > calls0  # the plain DP ran for these CPU tensors


def test_retry_and_oracle(data_dir):
    # budgets this small overflow the first envelope; reads longer than
    # Lmax go to the oracle directly
    lines, mapper = _map(
        data_dir, "ref2.fa", "reads2.fq", "10", max_read_len=160,
        seed_budget=16, shift_seed_budget=8, hit_budget=4, dp_frac=0.05,
        retry_hit_budget=256, retry_batch=64)
    assert lines == _golden(data_dir / "golden2_10.sam")
    assert mapper.stats.get("retried_reads", 0) > 0, mapper.stats
    assert mapper.stats["fallback_reads"] > 0, mapper.stats
