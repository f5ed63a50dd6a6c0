"""The port's mappy-compatible API (``gdiet_tpu_torch.api``) on the CPU.

The two cases of tests/test_api.py on the port's ``Aligner(device="cpu")``,
and its alignments against ``gdiet_tpu.api.Aligner``'s, field by field
(every ``Alignment`` field, cs and MD included) for every read of
``reads.fq``. Tolerance: exact.
"""

import dataclasses

import pytest

from gdiet_tpu_torch.api import Aligner, fastx_read, revcomp
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


OPTS = dict(preset="sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
            bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
            min_dp_max=100, AF_max_loc=2)


@pytest.fixture(scope="module")
def aligner(data_dir):
    return Aligner(str(data_dir / "ref.fa"), device="cpu", **OPTS)


def test_aligner_map_and_seq(data_dir, aligner):
    a = aligner
    assert a and a.n_seq == 1 and a.k == 21 and a.w == 11
    reads = list(fastx_read(str(data_dir / "reads.fq")))
    name, seq, qual = reads[0]
    hits = list(a.map(seq, cs=True, MD=True))
    assert hits, "read should map"
    h = hits[0]
    assert h.ctg in a.seq_names
    assert h.is_primary and h.r_en > h.r_st and h.q_en > h.q_st
    assert h.cigar_str.endswith("M") or "M" in h.cigar_str
    assert h.cs and h.MD
    # reference subsequence round-trip
    sub = a.seq(h.ctg, h.r_st, h.r_en)
    assert sub is not None and len(sub) == h.r_en - h.r_st
    # mapping the reverse complement flips the strand
    rc_hits = list(a.map(revcomp(seq)))
    assert rc_hits and rc_hits[0].strand == -hits[0].strand


def test_aligner_from_seq():
    genome = "ACGTTGCA" * 4000
    a = Aligner(seq=genome, preset="sr", pattern="10", device="cpu")
    assert a.n_seq == 1 and a.seq_names == ["N/A"]


def test_aligner_matches_jax(data_dir, aligner):
    from gdiet_tpu.api import Aligner as JaxAligner

    ref = JaxAligner(str(data_dir / "ref.fa"), **OPTS)
    n_hits = 0
    for name, seq, _ in fastx_read(str(data_dir / "reads.fq")):
        mine = [dataclasses.asdict(h) for h in aligner.map(seq, cs=True, MD=True)]
        want = [dataclasses.asdict(h) for h in ref.map(seq, cs=True, MD=True)]
        assert mine == want, name
        n_hits += len(mine)
    assert n_hits >= 40
    assert aligner.seq("chr1", 100, 160) == ref.seq("chr1", 100, 160)


def test_cuda_device_without_gpu_raises(data_dir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Aligner(str(data_dir / "ref.fa"), **OPTS)
