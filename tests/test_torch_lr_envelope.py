"""The long-read mapper's device envelope: reads up to 32,768 bp on the
device path, at the mapper's default envelope and budgets.

- CPU: four HiFi-model reads of 9-22 kb (over the 8,192 bp envelope the
  mapper had before) from a seeded random genome of 3 Mbp map through
  ``LongReadMapper`` with its defaults: every read reaches the device
  front, none goes to the scalar oracle, and every SAM line equals
  ``olr.map_read_lr``'s. The DP buckets are cut to (512, 1024) and (2048,
  3072), so the long segments take the exact host DP and the plain DP stays
  short on the CPU.
- CPU: the bounded front. With ``FRONT_BASES`` cut so that a batch takes
  three front calls, cut longest reads first, the last one narrower, the
  metas and the records equal one call's, on one device and on a (2, 2)
  mesh; a batch of one call keeps its rows in read order.
- CPU: each front call is as wide as its longest read needs (4,096 for
  one 4 kb read, 8,192 for a batch of 2-7 kb reads), with metas equal to
  a call at the full envelope and records equal to the oracle's; and the
  front's meta at the default envelope and budgets equals ``gdiet_tpu``'s.
- Card (``cuda``): the same HiFi reads and one ONT-model read of 25-30 kb
  under the ONT options of ``chip_smoke.py::phase_ont``, through the real
  buckets and the hand kernels, records equal to the oracle's. Run with
  ``python -m pytest --noconftest -m cuda tests/test_torch_lr_envelope.py``.
"""

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.config import options_for
from gdiet_tpu_torch.index import build_index
from gdiet_tpu_torch.io.fastx import SeqRecord
from gdiet_tpu_torch.oracle import longread as olr
from gdiet_tpu_torch.parallel import dist
from gdiet_tpu_torch.pipeline import longread
from gdiet_tpu_torch.testing import torch_threads

SEED = 2170017211
GENOME_LEN = 3_000_000
HIFI_LENS = (9_991, 13_316, 16_544, 21_699)
ONT_LEN = 27_000
# the published HiFi command line of the benchmark's configuration
HIFI = dict(pattern="10", k=19, w=19, max_seeds=0.2, bw=1000, vt_dis=650, vt_nb_loc=5,
            vt_df1=0.0106, vt_df2=0.2, min_dp_max=400, vt_cov=0.04, vt_f=0.04)
# chip_smoke.py::phase_ont's options
ONT = dict(pattern="10", k=15, w=10, max_seeds=0.2, bw=1300, vt_dis=1000, vt_nb_loc=3,
           vt_df1=0.007, vt_df2=0.007, max_min_gap=4000, vt_f=0.04, min_dp_max=35000,
           vt_cov=0.3, best_n=1)
SMALL_BUCKETS = [(512, 1024), (2048, 3072)]
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def genome() -> np.ndarray:
    return np.random.default_rng([SEED, 0]).integers(0, 4, GENOME_LEN).astype(np.uint8)


def sample_read(g: np.ndarray, n: int, length: int, rates: tuple, rng) -> SeqRecord:
    """``length`` source bases of ``g`` with substitutions, insertions and
    deletions at ``rates`` per base, reverse-complemented half the time."""
    sub, ins, dele = rates
    st = int(rng.integers(0, len(g) - length))
    src = g[st: st + length].copy()
    u = rng.random(length)
    hit = u < sub
    src[hit] = (src[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    keep = ~((u >= sub) & (u < sub + dele))
    extra = (u >= sub + dele) & (u < sub + dele + ins)
    out = []
    for b, k, x in zip(src, keep, extra):
        if k:
            out.append(b)
        if x:
            out.append(rng.integers(0, 4))
    arr = np.array(out, np.uint8)
    if rng.random() < 0.5:
        arr = (3 - arr[::-1]).astype(np.uint8)
    s = BASES[arr].tobytes().decode()
    return SeqRecord(f"r{n}", s, "I" * len(s))


def hifi_reads(g: np.ndarray) -> list:
    rng = np.random.default_rng([SEED, 1])
    return [sample_read(g, n, ln, (0.001, 0.0005, 0.0005), rng)
            for n, ln in enumerate(HIFI_LENS)]


def ont_read(g: np.ndarray) -> SeqRecord:
    return sample_read(g, 9, ONT_LEN, (0.03, 0.01, 0.01), np.random.default_rng([SEED, 2]))


def index_for(g: np.ndarray, preset: str, opts: dict, device: str):
    io_, mo = options_for(preset, variant="lr", **opts)
    return build_index([("chr1", BASES[g].tobytes().decode())], io_, device), mo


def oracle_lines(m, reads: list) -> list:
    return [m.regs_to_sam_lines(r, olr.map_read_lr(m.mi.oracle_view(), r.seq, m.mo,
                                                   m.mid_occ, r.name))
            for r in reads]


@pytest.fixture(scope="module")
def hifi():
    g = genome()
    mi, mo = index_for(g, "map-hifi", HIFI, "cpu")
    return {"mi": mi, "mo": mo, "reads": hifi_reads(g)}


@pytest.fixture(scope="module")
def mapped(hifi):
    """The HiFi reads through a default LongReadMapper on the CPU, and the
    oracle's lines."""
    m = longread.LongReadMapper(hifi["mi"], hifi["mo"], n_threads=2, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(longread, "DP_BUCKETS", SMALL_BUCKETS)
        regs = m.map_batch(hifi["reads"])
    return {"mapper": m, "lines": [m.regs_to_sam_lines(r, x)
                                   for r, x in zip(hifi["reads"], regs)],
            "oracle": oracle_lines(m, hifi["reads"])}


def test_reads_over_8192_bp_map_on_the_device_path(hifi, mapped):
    lens = [r.l_seq for r in hifi["reads"]]
    assert min(lens) > 8192 and max(lens) <= mapped["mapper"].Lmax == 32768
    st = mapped["mapper"].stats
    assert st["n_reads"] == st["front_reads"] == len(hifi["reads"])
    assert st["fallback_reads"] == st["front_fallback_reads"] == st["oracle_bases"] == 0
    assert st["host_dp_segments"] > 0  # the long segments took the host DP


@pytest.mark.parametrize("i", range(len(HIFI_LENS)))
def test_each_read_equals_the_oracle(mapped, i):
    lines = mapped["lines"][i]
    assert lines == mapped["oracle"][i]
    assert lines[0].split("\t")[2] == "chr1"


def _count_calls(monkeypatch, obj, name: str) -> list:
    """Wrap ``obj.name`` so that each call appends its codes' shape (rows,
    width)."""
    calls, fn = [], getattr(obj, name)

    def counted(codes, *a, **kw):
        calls.append(tuple(codes.shape))
        return fn(codes, *a, **kw)

    monkeypatch.setattr(obj, name, counted)
    return calls


def _count_lens(monkeypatch, obj, name: str) -> list:
    """Wrap ``obj.name`` so that each call appends its rows' lengths."""
    seen, fn = [], getattr(obj, name)

    def counted(codes, lens, *a, **kw):
        seen.append(lens.tolist())
        return fn(codes, lens, *a, **kw)

    monkeypatch.setattr(obj, name, counted)
    return seen


@pytest.mark.parametrize("meshed", [False, True], ids=["single", "mesh2x2"])
def test_bounded_front_splits_a_batch_and_keeps_its_results(hifi, mapped, monkeypatch,
                                                            meshed):
    # 7 reads, longest first: 2 at 32,768, 2 at 32,768, 3 at 16,384
    reads = [*hifi["reads"], *hifi["reads"][:3]]
    lens = np.array([r.l_seq for r in reads], np.int64)
    one = mapped["mapper"]._dispatch_front(reads, lens)[1].numpy()
    kw = {"mesh": dist.make_mesh(2, 2, ["cpu"] * 4)} if meshed else {}
    m = longread.LongReadMapper(hifi["mi"], hifi["mo"], device="cpu", **kw)
    if meshed:
        calls = _count_calls(monkeypatch, m, "_mesh_front")
    else:
        calls = _count_calls(monkeypatch, longread, "lr_front")
    monkeypatch.setattr(longread, "FRONT_BASES", 2 * m.Lmax + 1)
    monkeypatch.setattr(longread, "DP_BUCKETS", SMALL_BUCKETS)
    split = m._dispatch_front(reads, lens)[1].numpy()
    # mesh rows are padded to a multiple of the data axis (2)
    assert calls == [(2, 32768), (2, 32768), (4 if meshed else 3, 16384)]
    np.testing.assert_array_equal(split, one)
    assert (split[:, 3] > 0).all()  # candidates kept on every read
    calls.clear()
    got = [m.regs_to_sam_lines(r, x) for r, x in zip(reads, m.map_batch(reads))]
    assert len(calls) == 3
    assert got == mapped["lines"] + mapped["lines"][:3]
    assert m.stats["fallback_reads"] == 0


SHORT = {"one_4096": ((4096,), 4096), "one_3000": ((3000,), 4096),
         "2_to_7_kb": ((2500, 4096, 7000, 5200), 8192)}


@pytest.mark.parametrize("case", SHORT)
def test_front_call_is_as_wide_as_its_longest_read(hifi, mapped, monkeypatch, case):
    """Short reads run the front at their own width (seed budgets capped
    there), with the full envelope's metas and the oracle's records."""
    lens_in, width = SHORT[case]
    g = genome()
    rng = np.random.default_rng([SEED, 3, width, len(lens_in)])
    reads = [sample_read(g, 20 + j, ln, (0.001, 0.0, 0.0), rng) for j, ln in enumerate(lens_in)]
    lens = np.array([r.l_seq for r in reads], np.int64)
    assert tuple(lens) == lens_in
    m = mapped["mapper"]
    calls = _count_calls(monkeypatch, longread, "lr_front")
    seen = _count_lens(monkeypatch, longread, "lr_front")
    meta = m._dispatch_front(reads, lens)[1].numpy()
    assert calls == [(len(reads), width)]
    assert seen == [list(lens)]  # one call: its rows in read order
    with monkeypatch.context() as mp:
        mp.setattr(longread, "front_width", lambda n, lmax: lmax)
        full = m._dispatch_front(reads, lens)[1].numpy()
    assert calls[1] == (len(reads), 32768)
    np.testing.assert_array_equal(meta, full)
    assert (meta[:, 0] == 0).all() and (meta[:, 3] > 0).all()
    monkeypatch.setattr(longread, "DP_BUCKETS", SMALL_BUCKETS)
    got = [m.regs_to_sam_lines(r, x) for r, x in zip(reads, m.map_batch(reads))]
    assert got == oracle_lines(m, reads)
    assert all(ls[0].split("\t")[2] == "chr1" for ls in got)


def test_front_matches_jax_at_the_default_envelope(hifi, mapped):
    """The port's front meta of the four long reads at its defaults equals
    ``gdiet_tpu``'s front at the same envelope and budgets."""
    from gdiet_tpu.config import options_for as jax_options_for
    from gdiet_tpu.index import build_index as jax_build_index
    from gdiet_tpu.pipeline.longread import LongReadMapper as JaxMapper

    io_, jmo = jax_options_for("map-hifi", variant="lr", **HIFI)
    jmi = jax_build_index([("chr1", BASES[genome()].tobytes().decode())], io_)
    reads = hifi["reads"]
    lens = np.array([r.l_seq for r in reads], np.int64)
    jax_front = JaxMapper(jmi, jmo, max_read_len=32768, seed_budget=4096,
                          shift_seed_budget=1024, hit_budget=8192)
    ref = np.asarray(jax_front._dispatch_front(reads, lens)[3]["meta"])
    meta = mapped["mapper"]._dispatch_front(reads, lens)[1].numpy()
    assert meta.shape == ref.shape
    np.testing.assert_array_equal(meta, ref)
    assert (meta[:, 3] > 0).all()


@pytest.mark.cuda
def test_cuda_long_reads_equal_the_oracle():
    """HiFi reads of 9-22 kb and an ONT read of 27 kb through the default
    envelope and budgets on the card, the real DP buckets and kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from gdiet_tpu_torch.ops import extd2

    g = genome()
    for preset, opts, reads in (("map-hifi", HIFI, hifi_reads(g)),
                                ("map-ont", ONT, [ont_read(g)])):
        mi, mo = index_for(g, preset, opts, "cuda")
        m = longread.LongReadMapper(mi, mo, n_threads=2, device="cuda")
        launches = extd2.band_i16_launches.n
        regs = m.map_batch(reads)
        got = [m.regs_to_sam_lines(r, x) for r, x in zip(reads, regs)]
        st = m.stats
        assert st["front_reads"] == len(reads) and st["fallback_reads"] == 0, st
        assert st["host_dp_segments"] == 0 and extd2.band_i16_launches.n > launches
        assert got == oracle_lines(m, reads)
        assert all(ls[0].split("\t")[2] == "chr1" for ls in got)
