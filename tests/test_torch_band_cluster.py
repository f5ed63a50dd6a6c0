"""The int16 window kernel's clusters (``csrc/extd2_band_i16.cu``).

The kernel runs one candidate over a cluster of C blocks, block c owning
lane pairs [c P, (c+1) P) of the window's WB / 2 pairs. Here, on the CPU:

- ``ops/extd2.py::band_cluster_size``, the rule that picks C, as a pure
  function: the paths' shapes, the 64-pair floor of a block and the
  resident-cluster limit;
- the window geometry the design relies on, over the CASES of
  ``tests/test_torch_int16.py`` and the long-read paths' buckets: window
  lane 0 is in band only at lo = st = 0 (so pair 0's rotated neighbour,
  in block C-1, is never read: the band-start fixups replace it), and a
  shift moves the window base by 128 lanes, at most once per ``unroll``
  wavefronts.

The ``cuda`` cases launch the kernel at each cluster size it takes, on
the band CASES and on seeded windows at the paths' widths, against the
plain int16 version and the int32 kernel; a cluster size the kernel
refuses raises. On a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_band_cluster.py``.
"""

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import dp, dp_band, extd2
from gdiet_tpu_torch.testing import torch_threads

from test_torch_int16 import CASES, OUTPUTS, SCORING, _inputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


H100_SMS = 132
BAND_CASES = sorted(k for k, v in CASES.items() if v[0] == "band")


def _ample(C):
    """A card that holds any number of clusters: only the SMs bound C."""
    return 10_000


@pytest.mark.parametrize("N, WB, C", [
    (32, 1536, 4),    # the ONT (32768, 34048) chunk at band 1300
    (64, 768, 2),     # the HiFi 64-row (4096, 5120) call at band 500
    (128, 768, 1),    # the HiFi 128-row calls
    (128, 1536, 1),
    (33, 768, 4),     # 33 x 4 = 132 blocks
    (34, 768, 2),
    (16, 1536, 8),    # 96 pairs a block
    (16, 768, 4),     # 8 blocks would hold 48 pairs each
    (4, 512, 4),      # 64 pairs a block, the floor
    (4, 256, 2),
    (1, 128, 1),      # 64 pairs in all: no split
    (0, 1536, 8),
])
def test_cluster_size_rule(N, WB, C):
    got = extd2.band_cluster_size(N, WB, H100_SMS, _ample)
    assert got == C
    P, rem = divmod(WB // 2, got)
    assert rem == 0 and got in extd2.CLUSTER_SIZES
    assert got == 1 or (P >= extd2.MIN_CLUSTER_PAIRS and N * got <= H100_SMS)


def test_cluster_size_rule_resident_limit():
    """C shrinks to what the card holds resident at once, whatever the
    SMs allow, and ignores sizes it holds fewer of than N."""
    asked = []

    def resident(C):
        asked.append(C)
        return {2: 40, 4: 20, 8: 100}[C]

    assert extd2.band_cluster_size(32, 1536, H100_SMS, resident) == 2
    assert extd2.band_cluster_size(16, 1536, H100_SMS, resident) == 8
    assert extd2.band_cluster_size(41, 1536, H100_SMS, resident) == 1
    assert extd2.band_cluster_size(32, 1536, 64, _ample) == 2  # a smaller card
    assert 4 in asked


def _band_rows(name):
    """(lens, tlens, band) of a band case and its (T, R, WB, budget, unroll)."""
    _, _, _, _, Lmax, Lt, bb, U = CASES[name]
    _, _, lens, band, tlens = _inputs(name)
    T, R, WB = dp_band.band_shape(Lmax, Lt, bb, U)
    return lens, tlens, band, (T, R, WB, bb, U)


def _lane0_in_band(lens, tlens, band, T, R, WB, bb, U):
    """For each live (row, wavefront) where window lane 0 is in the band
    [st, en]: (lo, st). The band limits are the kernel's (ops/dp_band.py)."""
    r = np.arange(R)[None, :]
    lo = np.array([dp_band.window_base(r0 - r0 % U, bb, T, WB) for r0 in range(R)])[None, :]
    q, t, w = lens[:, None], tlens[:, None], band[:, None]
    st0 = np.maximum(np.maximum(0, r - q + 1), (r - w + 1) >> 1)
    en0 = np.minimum(np.minimum(t - 1, r), (r + w) >> 1)
    live = (st0 <= en0) & (r < q + t - 1) & (q > 0)
    st = st0 // 16 * 16
    en = np.minimum((en0 + 16) // 16 * 16 - 1, T - 1)
    hit = live & (lo >= st) & (lo <= en)
    return np.broadcast_to(lo, hit.shape)[hit], st[hit], live


@pytest.mark.parametrize("name", BAND_CASES)
def test_pair0_neighbour_unused_on_cases(name):
    lens, tlens, band, geom = _band_rows(name)
    assert (band <= geom[3]).all()
    lo, st, live = _lane0_in_band(lens, tlens, band, *geom)
    assert live.any()
    assert (lo == 0).all() and (st == 0).all()


@pytest.mark.parametrize("Lmax, Lt, bb", [(2048, 3072, 500), (4096, 5120, 500),
                                          (2048, 3072, 1300), (32768, 34048, 1300)])
def test_pair0_neighbour_unused_on_path_buckets(Lmax, Lt, bb):
    """The long-read buckets at the HiFi and ONT band budgets, rows of
    every band up to the budget and of short, full and unequal lengths."""
    U = dp_band.LR_UNROLL
    T, R, WB = dp_band.band_shape(Lmax, Lt, bb, U)
    assert WB is not None
    rng = np.random.default_rng(Lmax + bb)
    n = 24
    lens = np.concatenate([[Lmax, 1, 17, Lmax // 2], rng.integers(1, Lmax + 1, n - 4)])
    tlens = np.minimum(lens + rng.integers(0, Lt - Lmax + 1, n), Lt)
    tlens[1] = Lt
    band = np.concatenate([[bb, bb, 1, 2], rng.integers(1, bb + 1, n - 4)])
    lo, st, live = _lane0_in_band(lens.astype(np.int64), tlens.astype(np.int64),
                                  band.astype(np.int64), T, R, WB, bb, U)
    assert live.sum() > 0
    assert (lo == 0).all() and (st == 0).all()


@pytest.mark.parametrize("name", BAND_CASES)
def test_window_shifts(name):
    """The window base moves right only at multiples of ``unroll``, by
    exactly 128 lanes (64 lane pairs, no more than a block of a cluster
    holds), and the band_shift case shifts several times."""
    lens, tlens, _, (T, R, WB, bb, U) = _band_rows(name)
    base = [dp_band.window_base(r0, bb, T, WB) for r0 in range(0, R, U)]
    steps = np.diff(base)
    assert set(steps.tolist()) <= {0, 128}
    for r in range(R):  # within a grid step the base holds
        assert dp_band.lane_offset(r, T, WB, bb, U) == base[r // U]
    if name == "band_shift":
        r_end = int((lens + tlens - 1).max())
        assert (steps[: r_end // U] == 128).sum() >= 2


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")


def _check_every_cluster(q, t, ln, bd, prm, Lmax, tl, Lt, bb, U):
    """The int16 kernel at each cluster size it takes, and through
    ``extd2_batch`` (the rule's size): exact against the plain int16
    version and the int32 kernel (score and dirs: the card leaves offs
    and off_ends to dp.band_geometry); one launch each."""
    plain = dp_band.extd2_band(q, t, ln, bd, prm, Lmax, tl, Lt, bb, U, "int16")
    k32 = extd2.extd2_batch(q, t, ln, bd, prm, Lmax, tlens=tl, Lt=Lt, band_budget=bb,
                            unroll=U)
    WB = dp_band.band_shape(Lmax, Lt, bb, U)[2]
    sizes = extd2.band_cluster_sizes(WB)
    for C in sizes + [None]:
        n0 = extd2.band_i16_launches.n
        if C is None:
            got = extd2.extd2_batch(q, t, ln, bd, prm, Lmax, tlens=tl, Lt=Lt, band_budget=bb,
                                    unroll=U, state_dtype="int16")
        else:
            got = extd2._extd2_band_cuda(q, t, ln, bd, prm, Lmax, tl, Lt, bb, U, "int16",
                                         cluster=C)
        torch.cuda.synchronize()
        assert extd2.band_i16_launches.n == n0 + 1
        assert got[2] is None and got[3] is None
        for key, a, b, c in zip(OUTPUTS[:2], got, plain, k32):
            assert torch.equal(a, b), (C, key)
            assert torch.equal(a, c), (C, key)
    return sizes


@pytest.mark.cuda
@pytest.mark.parametrize("name", BAND_CASES)
def test_cuda_every_cluster_size_on_cases(name):
    _cuda_or_skip()
    _, preset, _, _, Lmax, Lt, bb, U = CASES[name]
    Q, T, lens, band, tlens = _inputs(name)
    q, t, ln, bd, tl = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band, tlens))
    sizes = _check_every_cluster(q, t, ln, bd, SCORING[preset], Lmax, tl, Lt, bb, U)
    assert len(sizes) >= 2


def _windows(N, Lmax, Lt, seed):
    """Seeded long-read windows: equal, 1% substitutions, indels,
    unrelated; N codes; a dead row."""
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 4, (N, Lmax), dtype=np.uint8)
    T = rng.integers(0, 4, (N, Lt), dtype=np.uint8)
    lens = rng.integers(Lmax * 3 // 4, Lmax + 1, N).astype(np.int32)
    tlens = np.minimum(lens + rng.integers(0, 65, N), Lt).astype(np.int32)
    for n in range(N):
        if n % 4 == 3:
            continue
        tt = Q[n].copy()
        if n % 4 >= 1:
            sub = rng.random(Lmax) < 0.01
            tt[sub] = (tt[sub] + 1) % 4
        if n % 4 == 2:
            p, g = int(rng.integers(10, Lmax - 10)), int(rng.integers(1, 9))
            tt = np.concatenate([tt[:p], rng.integers(0, 4, g), tt[p:]])[:Lmax]
        T[n, :Lmax] = tt
    Q[rng.random(Q.shape) < 0.001] = 4
    T[rng.random(T.shape) < 0.001] = 4
    lens[N // 2] = 0
    return Q, T, lens, tlens


@pytest.mark.cuda
@pytest.mark.parametrize("N, Lmax, Lt, bb, preset", [
    (8, 2048, 3072, 500, "map-hifi"),    # WB 768: C = 1, 2, 4
    (4, 4096, 5120, 1300, "map-ont"),    # WB 1,536: C = 1, 2, 4, 8
])
def test_cuda_every_cluster_size_at_path_widths(N, Lmax, Lt, bb, preset):
    _cuda_or_skip()
    Q, T, lens, tlens = _windows(N, Lmax, Lt, seed=Lmax + bb)
    band = np.full(N, bb, np.int32)
    q, t, ln, bd, tl = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band, tlens))
    sizes = _check_every_cluster(q, t, ln, bd, SCORING[preset], Lmax, tl, Lt, bb,
                                 dp_band.LR_UNROLL)
    assert sizes[-1] == (8 if bb == 1300 else 4)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 16, 4])
def test_cuda_refused_cluster_raises(C):
    """A cluster size the kernel does not take (3, 16; 4 at a 256-lane
    window: 32 pairs a block) raises with the CUDA error and launches
    nothing; no other size runs in its place."""
    _cuda_or_skip()
    _, preset, _, _, Lmax, Lt, bb, U = CASES["band_hifi"]
    Q, T, lens, band, tlens = _inputs("band_hifi")
    assert dp_band.band_shape(Lmax, Lt, bb, U)[2] == 256
    q, t, ln, bd, tl = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band, tlens))
    n0 = extd2.band_i16_launches.n
    with pytest.raises(RuntimeError, match="CUDA error"):
        extd2._extd2_band_cuda(q, t, ln, bd, SCORING[preset], Lmax, tl, Lt, bb, U,
                               "int16", cluster=C)
    assert extd2.band_i16_launches.n == n0


@pytest.mark.cuda
def test_cuda_plan_reports_the_rule():
    """``band_i16_plan`` gives the rule's size with the card's own SM count
    and resident clusters, and its block shape."""
    _cuda_or_skip()
    plan = extd2.band_i16_plan(32, 32768, 1536, "cuda")
    assert plan["cluster"] == extd2.band_cluster_size(
        32, 1536, plan["sms"], lambda C: extd2._resident(torch.device("cuda"), 32768, 1536, C))
    assert plan["pairs_per_block"] * plan["cluster"] == 768
    assert plan["max_active_clusters"] >= 32 or plan["cluster"] == 1
    assert dp.safe_state_dtype(SCORING["map-ont"]) == "int16"
