"""Kernel #1's int16 lane state (``state_dtype="int16"``) in the port, bit for bit.

``extd2_batch_pallas(..., state_dtype="int16")`` keeps the seven lane-state
arrays of the DP in int16 and the per-row H0 and score in int32. The port's
plain versions do the same with ``torch.int16`` tensors in all three
layouts: full width (``ops/dp.py``), the banded lane window
(``ops/dp_band.py``) and the fold (``ops/dp_fold.py``). Each is held here,
on the CPU, against the Pallas kernel's int16 interpret run and against
the port's own int32 route: score, the whole dirs, offs and off_ends,
exact, at the scoring of the sr, map-hifi and map-ont presets. The int16
route also runs outside ``safe_state_dtype``'s bound when that check is
lifted, and there it wraps and departs from int32: its state is 16-bit.

Every interpret call runs once per module, in a subprocess with XLA's CPU
fusion pass off (with it on, an unroll-8 windowed interpret call runs for
over half an hour).

The ``cuda`` cases hold each int16 kernel (``csrc/extd2_i16.cu``,
``extd2_band_i16.cu``, ``extd2_fold_i16.cu``) against its plain version and
against the int32 kernel on a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_int16.py``.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import dp, dp_band, dp_fold, extd2
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


ROOT = pathlib.Path(__file__).resolve().parent.parent
# the (a, b, q, e, q2, e2) of the presets (config.py::set_preset)
SCORING = {"sr": (2, 8, 12, 2, 24, 1), "map-hifi": (1, 4, 6, 2, 26, 1),
           "map-ont": (2, 4, 4, 2, 24, 1)}
# name: (layout, preset, seed, N, Lmax, Lt, band_budget, unroll); Lt None:
# no separate target budget (tlens = qlens)
CASES = {
    "full_sr": ("full", "sr", 1, 12, 48, None, None, 4),
    "full_ont": ("full", "map-ont", 2, 10, 64, 96, None, 4),
    # csrc/extd2_i16.cu's two-rows-a-warp layout (16 threads x 5 lane
    # pairs), and 256 lanes with rows on both of its launches: targets that
    # fit 160 lanes (the narrow layout) and wider ones (32 threads x 4)
    "full_sr160": ("full", "sr", 11, 8, 160, None, None, 4),
    "full_256": ("full", "sr", 14, 8, 256, 256, None, 4),
    "band_hifi": ("band", "map-hifi", 3, 8, 256, 512, 64, 8),
    "band_ont": ("band", "map-ont", 4, 6, 160, 384, 48, 4),
    # a 512-lane window (256 lane pairs: csrc/extd2_band_i16.cu's clusters
    # of 1, 2 and 4 blocks) that shifts as the band moves right
    "band_shift": ("band", "map-hifi", 10, 4, 512, 1024, 300, 8),
    "fold_sr": ("fold", "sr", 5, 16, 40, None, None, 4),
    "fold_hifi": ("fold", "map-hifi", 6, 12, 24, 48, None, 4),
}
OUTPUTS = ("score", "dirs", "offs", "off_ends")


def _inputs(name):
    """Equal, mutated (substitutions and 1-3 base indels) and unrelated
    windows, N codes, a dead row, varied bands; qlen 1/2..1 of Lmax, tlen
    qlen..qlen+32 within Lt."""
    _, _, seed, N, Lmax, Lt, bb, _ = CASES[name]
    Lt_ = Lt or Lmax
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 4, (N, Lmax), dtype=np.uint8)
    T = rng.integers(0, 4, (N, Lt_), dtype=np.uint8)
    L = min(Lmax, Lt_)
    for n in range(N):
        if n % 4 == 3:
            continue  # unrelated
        t = Q[n, :L].copy()
        if n % 4 == 1:
            for p in rng.integers(0, L, 4):
                t[p] = (t[p] + 1) % 4
        if n % 4 == 2:
            p, g = int(rng.integers(4, L - 4)), int(rng.integers(1, 4))
            t = np.concatenate([t[:p], rng.integers(0, 4, g), t[p:]])[:L]
        T[n, :L] = t
    Q[rng.random(Q.shape) < 0.02] = 4
    T[rng.random(T.shape) < 0.02] = 4
    lens = rng.integers(max(1, Lmax // 2), Lmax + 1, N).astype(np.int32)
    lens[N // 3] = 0
    tlens = (np.minimum(lens + rng.integers(0, 33, N), Lt_).astype(np.int32)
             if Lt else None)
    if bb is not None:
        band = np.full(N, bb, np.int32)
        band[1::3] = bb // 2
    else:
        band = rng.integers(8, 81, N).astype(np.int32)
    return Q, T, lens, band, tlens


def _port(name, state_dtype, device="cpu"):
    """The case through ``extd2.extd2_batch`` (CPU tensors: the plain
    version of the case's layout)."""
    layout, preset, _, _, Lmax, Lt, bb, U = CASES[name]
    Q, T, lens, band, tlens = _inputs(name)
    q, t, ln, bd = (torch.from_numpy(a).to(device) for a in (Q, T, lens, band))
    tl = None if tlens is None else torch.from_numpy(tlens).to(device)
    return extd2.extd2_batch(q, t, ln, bd, SCORING[preset], Lmax, tlens=tl, Lt=Lt,
                             fold=layout == "fold", band_budget=bb, unroll=U,
                             state_dtype=state_dtype)


def run_pallas(path):
    """Each case through ``extd2_batch_pallas(..., state_dtype="int16",
    interpret=True)``, the outputs saved to ``path`` (npz). Run as
    ``python -m tests.test_torch_int16 PATH`` with
    XLA_FLAGS=--xla_disable_hlo_passes=fusion."""
    import jax.numpy as jnp

    from gdiet_tpu.ops.dp_pallas import extd2_batch_pallas

    arrays = {}
    for name, (layout, preset, _, _, Lmax, Lt, bb, U) in CASES.items():
        Q, T, lens, band, tlens = _inputs(name)
        res = extd2_batch_pallas(
            jnp.asarray(Q), jnp.asarray(T), jnp.asarray(lens), jnp.asarray(band),
            SCORING[preset], Lmax, tlens=None if tlens is None else jnp.asarray(tlens),
            Lt=Lt, band_budget=bb, interpret=True, unroll=U, state_dtype="int16",
            fold=layout == "fold")
        for key, a in zip(OUTPUTS, res):
            arrays[f"{name}/{key}"] = np.asarray(a)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """{case: the Pallas kernel's int16 outputs}, from one subprocess."""
    tmp = tmp_path_factory.mktemp("int16")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_disable_hlo_passes=fusion",
           "JAX_COMPILATION_CACHE_DIR": str(tmp / "jax_cache")}
    res = subprocess.run([sys.executable, "-m", "tests.test_torch_int16", str(tmp / "p.npz")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    z = np.load(tmp / "p.npz")
    return {name: [z[f"{name}/{key}"] for key in OUTPUTS] for name in CASES}


def test_cases_engage_their_layouts():
    """The band cases' windows are narrower than their lane ranges, the
    full-width ones take no window, every case has a dead row and a third
    of the rows or more reach the corner."""
    for name, (layout, _, _, N, Lmax, Lt, bb, U) in CASES.items():
        windowed = bb is not None and dp_band.window_geometry(
            bb, dp.round_up(Lt or Lmax, 128), U) is not None
        assert windowed == (layout == "band"), name
        score = _port(name, "int32")[0]
        assert (score == dp.NEG_INF).any() and (score > dp.NEG_INF).sum() >= N // 3, name


def _full_width(ref, R: int, T: int):
    """The Pallas kernel's full-width outputs in ops/dp.py's layout: its
    dirs [N, R8, round128(Lt)] and offs/off_ends [N, R8] hold ops/dp.py's
    [N, R, round16(Lt)] and [N, R], with zero dirs and dead offs (lane
    round128(Lt)) around them; the port writes T = round16(Lt) for dead."""
    score, dirs, offs, off_ends = ref
    T128 = dirs.shape[2]
    assert not dirs[:, R:].any() and not dirs[:, :, T:].any()
    assert (offs[:, R:] == T128).all() and (off_ends[:, R:] == -1).all()
    offs = np.where(offs == T128, T, offs)
    return score, dirs[:, :R, :T], offs[:, :R], off_ends[:, :R]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_int16_matches_pallas_int16(pallas, name):
    layout, _, _, _, Lmax, Lt, _, _ = CASES[name]
    ref = pallas[name]
    if layout == "full":
        ref = _full_width(ref, Lmax + (Lt or Lmax) - 1, dp.round16(Lt or Lmax))
    plain = {"full": dp.calls, "band": dp_band.calls, "fold": dp_fold.calls}[layout]
    calls = plain.n
    launched = (extd2.i16_launches.n, extd2.band_i16_launches.n, extd2.fold_i16_launches.n)
    got = _port(name, "int16")
    # CPU tensors take the plain version of the layout, never a kernel
    assert plain.n == calls + 1
    assert launched == (extd2.i16_launches.n, extd2.band_i16_launches.n,
                        extd2.fold_i16_launches.n)
    for key, a, b in zip(OUTPUTS, got, ref):
        assert tuple(a.shape) == b.shape, key
        np.testing.assert_array_equal(a.numpy(), b, err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_int16_matches_int32(name):
    for key, a, b in zip(OUTPUTS, _port(name, "int16"), _port(name, "int32")):
        assert torch.equal(a, b), key


@pytest.mark.parametrize("layout", ["full", "band", "fold"])
def test_int16_state_is_16_bit(monkeypatch, layout):
    """With the bound check lifted, a scoring far outside it makes the
    int16 route wrap: its dirs depart from the int32 route's."""
    monkeypatch.setattr(dp, "state_dtype_of", lambda params, sd: (
        torch.int16 if sd == "int16" else torch.int32))
    monkeypatch.setattr(dp_band, "state_dtype_of", dp.state_dtype_of)
    name = {"full": "full_ont", "band": "band_ont", "fold": "fold_sr"}[layout]
    _, _, _, _, Lmax, Lt, bb, U = CASES[name]
    Q, T, lens, band, tlens = _inputs(name)
    args = [torch.from_numpy(a) for a in (Q, T, lens, band)]
    tl = None if tlens is None else torch.from_numpy(tlens)
    huge = (2000, 8000, 6000, 2000, 12000, 1000)
    assert dp.safe_state_dtype(huge) == "int32"
    out = [extd2.extd2_batch(*args, huge, Lmax, tlens=tl, Lt=Lt, fold=layout == "fold",
                             band_budget=bb, unroll=U, state_dtype=sd)
           for sd in ("int32", "int16")]
    assert not torch.equal(out[0][1], out[1][1])


def test_safe_state_dtype_matches_jax():
    from gdiet_tpu.ops import dp_pallas

    rng = np.random.default_rng(8)
    sweep = [tuple(int(v) for v in rng.integers(0, 3000, 6)) for _ in range(200)]
    sweep += list(SCORING.values())
    # both sides of the bound: 4 * sum < 32767 <=> sum <= 8191
    sweep += [(8191 - 5, 1, 1, 1, 1, 1), (8192 - 5, 1, 1, 1, 1, 1), (0, 0, 0, 0, 0, 8191),
              (0, 0, 0, 0, 0, 8192), (1, 19, 39, 81, 3, 1)]
    kinds = set()
    for prm in sweep:
        assert dp.safe_state_dtype(prm) == dp_pallas.safe_state_dtype(prm), prm
        kinds.add(dp.safe_state_dtype(prm))
    assert kinds == {"int16", "int32"}
    for prm in SCORING.values():
        assert dp.safe_state_dtype(prm) == "int16"


@pytest.mark.parametrize("layout", ["full", "band", "fold"])
def test_int16_outside_the_bound_raises(layout):
    """``state_dtype="int16"`` with scoring outside the bound raises
    ValueError in every layout (dp_pallas.py's assert), before any work;
    an unknown state_dtype too."""
    name = {"full": "full_sr", "band": "band_hifi", "fold": "fold_sr"}[layout]
    _, _, _, _, Lmax, Lt, bb, U = CASES[name]
    Q, T, lens, band, tlens = _inputs(name)
    args = [torch.from_numpy(a) for a in (Q, T, lens, band)]
    tl = None if tlens is None else torch.from_numpy(tlens)
    unsafe = (2, 8, 12, 2, 8190, 1)
    kw = dict(tlens=tl, Lt=Lt, fold=layout == "fold", band_budget=bb, unroll=U)
    calls = (dp.calls.n, dp_band.calls.n, dp_fold.calls.n)
    with pytest.raises(ValueError, match="int16"):
        extd2.extd2_batch(*args, unsafe, Lmax, state_dtype="int16", **kw)
    with pytest.raises(ValueError, match="state_dtype"):
        extd2.extd2_batch(*args, SCORING["sr"], Lmax, state_dtype="int8", **kw)
    assert calls == (dp.calls.n, dp_band.calls.n, dp_fold.calls.n)
    plain = {"full": lambda: dp.extd2_batch(*args, unsafe, Lmax, tl, Lt, "int16"),
             "band": lambda: dp_band.extd2_band(*args, unsafe, Lmax, tl, Lt, bb, U, "int16"),
             "fold": lambda: dp_fold.extd2_fold(*args, unsafe, Lmax, tl, Lt, "int16")}
    with pytest.raises(ValueError, match="int16"):
        plain[layout]()


def test_short_read_route():
    """The short-read step's DP takes int16 at the full widths where the
    int16 kernel measured faster (112, 128, 160, 192, 256 and 512 lanes;
    100 bp reads round to 112) and for the fold at 160 lanes (the SE and PE
    steps' width, where csrc/extd2_fold_i16.cu measured faster than
    csrc/extd2_fold.cu); int32 at unmeasured widths (96, 144, 1024 lanes;
    the fold at 128 and 256) and for any scoring outside the bound."""
    from gdiet_tpu_torch.ops.extd2 import I16_FOLD_SHAPES, route_state_dtype

    sr = SCORING["sr"]
    assert [route_state_dtype(sr, L) for L in (100, 112, 128, 150, 160, 192, 256, 512)] == [
        "int16"] * 8
    assert {route_state_dtype(sr, L) for L in (96, 144, 1024)} == {"int32"}
    assert I16_FOLD_SHAPES == {(160, 160)}
    assert [route_state_dtype(sr, L, fold=True) for L in (150, 160)] == ["int16"] * 2
    assert {route_state_dtype(sr, L, fold=True) for L in (128, 256)} == {"int32"}
    unsafe = (2, 8, 12, 2, 8190, 1)
    assert {route_state_dtype(unsafe, L, fold=f) for L in (160, 256)
            for f in (False, True)} == {"int32"}


@pytest.mark.parametrize("preset", ["map-hifi", "map-ont"])
def test_long_read_route(preset):
    """The LR buckets' DP takes int16 wherever the banded window engages
    and at the full-width (512, 1024) bucket; a full-width bucket of
    another shape (unmeasured) and scoring outside the bound keep int32."""
    from gdiet_tpu_torch.ops.extd2 import route_state_dtype

    prm, U = SCORING[preset], dp_band.LR_UNROLL
    for lq, lt in ((2048, 3072), (4096, 5120), (32768, 34048)):
        assert dp_band.window_geometry(500, lt, U) is not None
        assert route_state_dtype(prm, lq, lt, band_budget=500, unroll=U) == "int16"
    assert route_state_dtype(prm, 512, 1024, band_budget=1000, unroll=U) == "int16"
    assert dp_band.window_geometry(4000, 3072, U) is None
    assert route_state_dtype(prm, 2048, 3072, band_budget=4000, unroll=U) == "int32"
    unsafe = (2, 8, 12, 2, 8190, 1)
    assert route_state_dtype(unsafe, 2048, 3072, band_budget=500, unroll=U) == "int32"


def test_fold_split_matches_jax_int16():
    """The fold's row block follows the lane state's bytes, as
    ``_extd2_fold``'s VMEM budget does (int16: 7 * 2 + 8 bytes a lane)."""
    from gdiet_tpu.ops import dp_pallas

    for T in (128, 256, 384, 768, 1024, 4096):
        for N in (0, 1, 37, 192, 400, 5120, 6272, 20000):
            for isz, sd in ((4, "int32"), (2, "int16")):
                NB = max(8, min(192, (10 << 19) // ((7 * isz + 8) * T) // 16 * 16))
                Nrows = dp_pallas._round_up(max(1, -(-N // dp_pallas.FOLD_PASSES)), NB)
                assert dp_fold.fold_split(N, T, sd) == (NB, Nrows, max(1, -(-N // Nrows)))
    # the split differs from 768 lanes on, and not at the short-read width
    assert dp_fold.fold_split(400, 768, "int16") != dp_fold.fold_split(400, 768)
    assert dp_fold.fold_split(5120, 256, "int16") == dp_fold.fold_split(5120, 256)


def _cuda_case(name, kernel_count):
    """The case on the card through the int16 kernel: score and dirs exact
    against the plain int16 version on the card and against the int32
    kernel (the card leaves offs and off_ends to dp.band_geometry); the
    int16 kernel launched once, or once per entry of
    ``extd2.i16_full_plan`` on the full width's warp route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    layout, preset, _, _, Lmax, Lt, bb, U = CASES[name]
    Q, T, lens, band, tlens = _inputs(name)
    T_ = dp.round16(Lt or Lmax)
    want = 1
    if layout == "full" and T_ <= extd2.I16_WARP_LANES:
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        want = len(extd2.i16_full_plan(len(lens), T_, n_sms))
    n0 = kernel_count.n
    got = _port(name, "int16", "cuda")
    torch.cuda.synchronize()
    assert kernel_count.n == n0 + want
    assert got[2] is None and got[3] is None
    q, t, ln, bd = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
    tl = None if tlens is None else torch.from_numpy(tlens).cuda()
    prm = SCORING[preset]
    if layout == "band":
        plain = dp_band.extd2_band(q, t, ln, bd, prm, Lmax, tl, Lt, bb, U, "int16")
    elif layout == "fold":
        plain = dp_fold.extd2_fold(q, t, ln, bd, prm, Lmax, tl, Lt, "int16")
    else:
        plain = dp.extd2_batch(q, t, ln, bd, prm, Lmax, tl, Lt, "int16")
    for key, a, b in zip(OUTPUTS[:2], got, plain):
        assert torch.equal(a, b), key
    for key, a, b in zip(OUTPUTS[:2], got, _port(name, "int32", "cuda")):
        assert torch.equal(a, b), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["full_sr", "full_ont", "full_sr160", "full_256"])
def test_cuda_int16_kernel_full_width(name):
    _cuda_case(name, extd2.i16_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["band_hifi", "band_ont"])
def test_cuda_int16_kernel_band(name):
    _cuda_case(name, extd2.band_i16_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fold_sr", "fold_hifi"])
def test_cuda_int16_kernel_fold(name):
    _cuda_case(name, extd2.fold_i16_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [5120, 6272])
def test_cuda_int16_fold_at_path_shapes(N):
    """The fold at the PE step's call (5,120 rows of 4,096 pairs: 384
    kernel rows x 14 passes) and the SE step's (6,272 rows: 576 x 11), 160
    lanes, where the route takes int16: csrc/extd2_fold_i16.cu (filler and
    walker warps) launched once, score and dirs exact against the int32 kernel and
    the plain int16 fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    prm, L = SCORING["sr"], 160
    assert extd2.route_state_dtype(prm, L, fold=True) == "int16"
    rng = np.random.default_rng(N)
    Q = rng.integers(0, 4, (N, L), dtype=np.uint8)
    T = Q.copy()
    T[rng.random(T.shape) < 0.01] = 1
    Q[rng.random(Q.shape) < 0.002] = 4
    lens = rng.integers(100, 151, N).astype(np.int32)
    lens[::97] = 0
    band = rng.integers(150, 201, N).astype(np.int32)
    q, t, ln, bd = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
    n0 = extd2.fold_i16_launches.n
    got = extd2.extd2_batch(q, t, ln, bd, prm, L, fold=True, state_dtype="int16")
    torch.cuda.synchronize()
    assert extd2.fold_i16_launches.n == n0 + 1
    ref32 = extd2.extd2_batch(q, t, ln, bd, prm, L, fold=True)
    plain = dp_fold.extd2_fold(q, t, ln, bd, prm, L, None, None, "int16")
    for key, a, b, c in zip(OUTPUTS[:2], got, ref32, plain):
        assert torch.equal(a, b) and torch.equal(a, c), key


@pytest.mark.cuda
def test_cuda_int16_fold_backtrack_reads_its_split():
    """At 1,024 fold lanes the int16 fold's row split (192 rows) differs
    from the int32 one's (128): the backtrack kernel takes the split from
    the dirs and walks both to the same ops as the plain folded walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from gdiet_tpu_torch.ops.backtrack import backtrack_antidiag

    rng = np.random.default_rng(12)
    N, L = 200, 900
    Q = rng.integers(0, 4, (N, L), dtype=np.uint8)
    T = Q.copy()
    T[rng.random(T.shape) < 0.01] = 1
    lens = rng.integers(L // 2, L + 1, N).astype(np.int32)
    band = np.full(N, 60, np.int32)
    q, t, ln, bd = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
    prm = SCORING["sr"]
    _, Tf, _ = dp_fold.fold_geometry(L)
    assert dp_fold.fold_split(N, Tf, "int16")[1] != dp_fold.fold_split(N, Tf)[1]
    ops = []
    for sd in ("int32", "int16"):
        out = extd2.extd2_batch(q, t, ln, bd, prm, L, fold=True, state_dtype=sd)
        bt = extd2.backtrack_band(out[1], ln, ln, bd, L, L, fold=True)
        ref = backtrack_antidiag(out[1], ln, bd, L, fold=True)
        for a, b in zip(bt, ref):
            assert torch.equal(a, b)
        ops.append(bt)
    for a, b in zip(*ops):
        assert torch.equal(a, b)


if __name__ == "__main__":
    run_pallas(sys.argv[1])
