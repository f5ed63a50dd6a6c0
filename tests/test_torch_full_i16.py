"""The full-width int16 DP's warp route (``csrc/extd2_i16.cu``): its launch
plan and the facts of the band its lane layouts rest on, on the CPU; the
kernel against its plain version on a card.

``ops/extd2.py::i16_full_plan`` is the plan the kernel takes (each entry
one launch of ``gdiet_extd2_i16_warp``): a layout of G threads a row and
NS lane pairs a thread, the rows a DP warp takes and the zero warps. The
layouts rest on two facts of
the plain version (``ops/dp.py``), held here on every full-width case of
``tests/test_torch_int16.py`` and at the paths' shapes:

- the band [offs, off_ends] of a live wavefront starts at a multiple of 16
  and ends one below a multiple of 16 or at T - 1, so the 8 or 16 lanes of
  a thread (PPT 4 or 8) and every lane pair are in band or out as a whole;
- a row whose target fits 160 lanes (round16(tlen) <= 160) never has a
  lane past 159 in band and scores the same at any width: above 160 lanes
  such rows run in the 160-lane layout.

The ``cuda`` cases run on a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_full_i16.py``.
"""

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import dp, extd2
from gdiet_tpu_torch.testing import torch_threads
from test_torch_int16 import CASES, SCORING, _inputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


MAX = 2 ** 31 - 1
# (N, T) of the paths' full-width calls on 132 SMs (the H100's): the SE
# step (6,272 rows of 160 lanes), the generic step at 256 and 512 lanes,
# and the route's other widths at the SE batch's rows; each launch (W, G,
# NS, tl_lo, tl_hi, chunk, split, head warps, zero warps, DP warps)
PLANS = {
    (6272, 112): [(128, 16, 4, 0, MAX, 2, 0, 0, 264, 3136)],
    (6272, 128): [(128, 16, 4, 0, MAX, 2, 0, 0, 264, 3136)],
    (6272, 160): [(160, 16, 5, 0, MAX, 2, 0, 0, 264, 3136)],
    (6272, 192): [(160, 16, 5, 0, 160, 2, 0, 0, 264, 3136),
                  (192, 16, 6, 160, MAX, 2, 0, 0, 0, 3136)],
    # 52,864 rows in chunks of 14, the last 12,672 (48 warps of rows an SM)
    # one round (2 rows) a warp
    (65536, 256): [(160, 16, 5, 0, 160, 14, 52864, 3776, 264, 10112),
                   (256, 32, 4, 160, MAX, 1, 0, 0, 0, 65536)],
    (8192, 512): [(160, 16, 5, 0, 160, 2, 0, 0, 264, 4096),
                  (512, 32, 8, 160, MAX, 1, 0, 0, 0, 8192)],
}
KEYS = ("W", "G", "NS", "tl_lo", "tl_hi", "chunk", "split", "head_warps", "zero_warps",
        "dp_warps")


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan_at_the_paths_shapes(shape):
    N, T = shape
    plan = extd2.i16_full_plan(N, T, 132)
    assert [tuple(p[k] for k in KEYS) for p in plan] == PLANS[shape]
    for p in plan:
        assert p["W"] == 2 * p["G"] * p["NS"] and 32 % p["G"] == 0
        rpw = 32 // p["G"]
        assert p["chunk"] % rpw == 0 and p["chunk"] <= 32
        # chunks cover the rows below split, one round a warp the rest
        assert p["head_warps"] * p["chunk"] >= p["split"] > (p["head_warps"] - 1) * p["chunk"] \
            or p["split"] == p["head_warps"] == 0
        assert p["dp_warps"] - p["head_warps"] == -(-(N - p["split"]) // rpw)
    # the launches split the rows by their target: every row lands in one
    assert plan[0]["tl_lo"] == 0 and plan[-1]["tl_hi"] == MAX
    assert all(a["tl_hi"] == b["tl_lo"] for a, b in zip(plan, plan[1:]))
    # the last launch takes the narrowest layout that covers T
    assert plan[-1]["W"] == min(W for W, _, _ in extd2.I16_LAYOUTS if W >= T)


def test_plan_limits():
    """A DP warp takes its rows a warp until the call holds more than 32
    warps of rows an SM, and at most 32 rows (one row where a warp holds
    one), the last 48 warps of rows an SM one round a warp; the zero warps
    never outnumber the rows; widths past 256 lanes take the 512-lane
    layout; the warp route ends at 512 lanes."""
    assert extd2.i16_full_plan(3, 48, 132) == [
        {"W": 64, "G": 8, "NS": 4, "tl_lo": 0, "tl_hi": MAX, "chunk": 4, "split": 0,
         "head_warps": 0, "zero_warps": 3, "dp_warps": 1}]
    assert [p["W"] for p in extd2.i16_full_plan(100, 320, 132)] == [160, 512]
    big = extd2.i16_full_plan(10 ** 6, 128, 132)[0]
    assert big["chunk"] == 32 and big["split"] == 10 ** 6 - 2 * 132 * 48
    assert extd2.i16_full_plan(2 * 132 * 32 * 2, 160, 132)[0]["chunk"] == 4
    assert extd2.i16_full_plan(10 ** 6, 256, 132)[1]["chunk"] == 1
    for bad in ((10, 528), (10, 0), (0, 160)):
        with pytest.raises(ValueError):
            extd2.i16_full_plan(*bad, 132)


def _path_rows(N: int, L: int, seed: int):
    """Seeded rows at the paths' widths: reads of L - 10 to L bases (150
    at 160 lanes and above), dead rows, the sr preset's bands (150-200)."""
    rng = np.random.default_rng(seed)
    ql = min(L, 150) if L >= 160 else L - 10
    lens = rng.integers(ql - 10, ql + 1, N).astype(np.int32)
    lens[rng.random(N) < 0.3] = 0
    band = rng.integers(150, 201, N).astype(np.int32)
    return torch.from_numpy(lens), torch.from_numpy(band)


def _check_aligned(offs, off_ends, T: int):
    live = off_ends >= 0
    st, en = offs[live], off_ends[live]
    assert bool((st % 16 == 0).all())
    assert bool((((en + 1) % 16 == 0) | (en == T - 1)).all())
    # hence a pair (lanes 2j, 2j+1) and a thread's 8 or 16 aligned lanes
    # are in band or out as a whole
    for group in (2, 8, 16):
        assert bool((st % group == 0).all()) and bool(((en + 1) % group == 0).all())


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c[0] == "full"))
def test_band_edges_are_group_aligned_on_cases(name):
    _, preset, _, _, Lmax, Lt, _, _ = CASES[name]
    Q, T, lens, band, tlens = _inputs(name)
    Lt_ = Lt or Lmax
    ln, bd = torch.from_numpy(lens), torch.from_numpy(band)
    tl = None if tlens is None else torch.from_numpy(tlens)
    _, _, offs, off_ends = dp.extd2_batch(torch.from_numpy(Q), torch.from_numpy(T), ln, bd,
                                          SCORING[preset], Lmax, tl, Lt, "int16")
    assert bool((off_ends >= 0).any())
    _check_aligned(offs, off_ends, dp.round16(Lt_))


@pytest.mark.parametrize("L", [112, 128, 160, 192, 256, 512])
def test_band_edges_are_group_aligned_at_path_shapes(L):
    lens, band = _path_rows(4096, L, L)
    T, R = dp.round16(L), 2 * L - 1
    offs, off_ends = dp.band_geometry(lens, None, band, R, T)
    assert bool((off_ends >= 0).any())
    _check_aligned(offs, off_ends, T)


def test_narrow_rows_stay_in_160_lanes():
    """Rows whose target fits 160 lanes, at 256 lanes: no lane past 159 in
    band, zero dirs there, and score and dirs as the same rows give at 160
    lanes (so the H0 walk never reads past lane 159 either)."""
    rng = np.random.default_rng(21)
    N, Lmax = 24, 256
    tl = rng.integers(1, 161, N).astype(np.int32)
    ql = rng.integers(1, 201, N).astype(np.int32)
    ql[::7] = 0
    Q = rng.integers(0, 4, (N, Lmax), dtype=np.uint8)
    Tg = rng.integers(0, 4, (N, 256), dtype=np.uint8)
    for n in range(N):  # related pairs in most rows
        k = min(ql[n], tl[n])
        if n % 3:
            Tg[n, :k] = Q[n, :k]
    Q[rng.random(Q.shape) < 0.02] = 4
    band = rng.integers(8, 300, N).astype(np.int32)
    args = [torch.from_numpy(a) for a in (Q, Tg, ql, band)]
    prm = SCORING["sr"]
    wide = dp.extd2_batch(*args, prm, Lmax, torch.from_numpy(tl), 256, "int16")
    args[1] = args[1][:, :160].contiguous()
    narrow = dp.extd2_batch(*args, prm, Lmax, torch.from_numpy(tl), 160, "int16")
    assert int(wide[3].max()) <= 159
    assert not wide[1][:, :, 160:].any()
    assert torch.equal(wide[0], narrow[0])
    R = Lmax + 159
    assert torch.equal(wide[1][:, :R, :160], narrow[1]) and not wide[1][:, R:].any()
    assert (wide[0] > dp.NEG_INF).sum() >= N // 3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(PLANS))
def test_cuda_plan_layouts_resident(shape):
    """``i16_plan`` is ``i16_full_plan`` on this card's SMs, and every
    layout it launches is resident and spill-free."""
    _need_card()
    N, T = shape
    got = extd2.i16_plan(N, T, T, "cuda")
    want = extd2.i16_full_plan(N, T, got[0]["sms"])
    assert [{k: p[k] for k in KEYS} for p in got] == want
    for p in got:
        assert p["blocks_per_sm"] >= 1 and p["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("L", [160, 256])
def test_cuda_many_rows_each_chunk(L):
    """More rows than 32 warps of rows an SM, so that a DP warp takes
    several rounds of rows (and at 256 lanes rows of both launches), dead
    rows among them: score and dirs exact against the plain int16 version
    and extd2.cu; one launch per entry of the plan."""
    _need_card()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    N = 2 * n_sms * 32 * 2 + 37
    assert extd2.i16_full_plan(N, L, n_sms)[0]["chunk"] > 2
    rng = np.random.default_rng(L)
    lens, band = _path_rows(N, L, L + 1)
    tl = lens.clone()
    if L > 160:
        tl = torch.where(torch.from_numpy(rng.random(N) < 0.2), torch.full_like(tl, L), tl)
        lens = torch.where(tl == L, torch.full_like(lens, L - 5), lens)
    Q = rng.integers(0, 4, (N, L), dtype=np.uint8)
    Tg = Q.copy()
    Tg[rng.random(Tg.shape) < 0.01] = 2
    q, t, ln, bd, tlc = (torch.as_tensor(a).cuda() for a in (Q, Tg, lens, band, tl))
    prm = SCORING["sr"]
    n0 = extd2.i16_launches.n
    got = extd2.extd2_batch(q, t, ln, bd, prm, L, tlens=tlc, Lt=L, state_dtype="int16")
    torch.cuda.synchronize()
    assert extd2.i16_launches.n == n0 + len(extd2.i16_full_plan(N, L, n_sms)) == n0 + 2 - (L <= 160)
    assert got[2] is None and got[3] is None
    for a, b in zip(got[:2], dp.extd2_batch(q, t, ln, bd, prm, L, tlc, L, "int16")):
        assert torch.equal(a, b)
    for a, b in zip(got[:2], extd2.extd2_batch(q, t, ln, bd, prm, L, tlens=tlc, Lt=L)):
        assert torch.equal(a, b)
