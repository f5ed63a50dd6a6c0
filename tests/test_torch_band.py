"""Port banded lane window vs gdiet_tpu's Pallas kernel, bit for bit, on the CPU.

The windowed mode of ``_dp_kernel`` (``band_budget`` set, the mode of every
long-read DP bucket) has no plain-XLA reference, so the port's plain
banded version (``ops/dp_band.py::extd2_band``) is held against
``extd2_batch_pallas(..., band_budget=..., unroll=..., interpret=True)``:
score, the whole dirs [N, R, WB], offs and off_ends, exact. In the unroll-8
case the window (WB = 256 of T = 512 lanes) moves twice, once while rows
are live, and is clipped at T - WB; rows have unequal target lengths, N
codes and dead rows. A second case runs unroll 4. The port's windowed
backtrack is held against ``_backtrack_antidiag(band_budget=...,
unroll=...)`` on those dirs.

Both interpret calls run once per module, in a subprocess with XLA's CPU
fusion pass off: with it on, an unroll-8 call runs for over half an hour
on a CPU; with it off, seconds. The outputs are integers, and at unroll 4
the two runs agree byte for byte.
Two invariants the CUDA kernels are built on are held against the Pallas
kernel and the plain walk here: every dirs row from wavefront qlen+tlen-1
on (all rows of a qlen-0 candidate) is zero, in the windowed mode and at
full width, so ``extd2_band.cu`` and ``extd2.cu`` end a candidate there;
and ``dp_band.backtrack_tile`` covers every byte the walk reads, so
``backtrack_band.cu`` can stage its tiles by it.
The CUDA kernels (``csrc/extd2_band.cu``, ``csrc/backtrack_band.cu``) are
held against the plain versions on a card: ``python -m pytest --noconftest
-m cuda tests/test_torch_band.py``.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import backtrack, dp, dp_band, extd2
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


PARAMS = (1, 4, 6, 2, 26, 1)  # the map-hifi preset's scoring


def _pairs(seed, N, Lmax, Lt):
    """Equal, mutated (substitutions and 1-3 base indels) and unrelated
    windows, N codes, dead rows; qlen 3/4..1 of Lmax, tlen qlen..qlen+32."""
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 4, (N, Lmax), dtype=np.uint8)
    T = rng.integers(0, 4, (N, Lt), dtype=np.uint8)
    lens = rng.integers(Lmax * 3 // 4, Lmax + 1, N).astype(np.int32)
    tlens = np.minimum(lens + rng.integers(0, 33, N), Lt).astype(np.int32)
    for n in range(N):
        if n % 4 == 3:
            continue  # unrelated
        t = Q[n].copy()
        if n % 4 == 1:
            for p in rng.integers(0, Lmax, 6):
                t[p] = (t[p] + 1) % 4
        if n % 4 == 2:
            p, g = int(rng.integers(10, Lmax - 10)), int(rng.integers(1, 4))
            t = np.concatenate([t[:p], rng.integers(0, 4, g), t[p:]])[:Lmax]
        T[n, :Lmax] = t
    Q[rng.random(Q.shape) < 0.01] = 4
    T[rng.random(T.shape) < 0.01] = 4
    lens[5] = 0
    return Q, T, lens, tlens


# name: (seed, N, Lmax, Lt, band_budget, unroll); WB = 256 in both
CASES = {"unroll8": (5, 8, 256, 512, 64, 8), "unroll4": (7, 6, 160, 384, 48, 4)}
# (seed, N, Lmax, Lt) of a full-width Pallas run (no band budget)
FULL_PALLAS = (9, 6, 48, 64)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _inputs(name):
    seed, N, Lmax, Lt, bb, _ = CASES[name]
    Q, T, lens, tlens = _pairs(seed, N, Lmax, Lt)
    band = np.full(N, bb, np.int32)
    band[1::3] = bb // 2
    return Q, T, lens, band, tlens


def _full_pallas_inputs():
    seed, N, Lmax, Lt = FULL_PALLAS
    Q, T, lens, tlens = _pairs(seed, N, Lmax, Lt)
    band = np.full(N, 40, np.int32)
    band[1::3] = 12
    return Q, T, lens, band, tlens


def run_pallas(path):
    """Each case through ``extd2_batch_pallas(..., interpret=True)``, the
    outputs saved to ``path`` (npz). Run as ``python -m
    tests.test_torch_band PATH`` with XLA_FLAGS=--xla_disable_hlo_passes=fusion."""
    import jax.numpy as jnp

    from gdiet_tpu.ops.dp_pallas import extd2_batch_pallas

    arrays = {}
    for name, (_, _, Lmax, Lt, bb, U) in CASES.items():
        Q, T, lens, band, tlens = _inputs(name)
        res = extd2_batch_pallas(jnp.asarray(Q), jnp.asarray(T), jnp.asarray(lens),
                                 jnp.asarray(band), PARAMS, Lmax, tlens=jnp.asarray(tlens),
                                 Lt=Lt, band_budget=bb, interpret=True, unroll=U)
        for key, a in zip(("score", "dirs", "offs", "off_ends"), res):
            arrays[f"{name}/{key}"] = np.asarray(a)
    _, _, Lmax, Lt = FULL_PALLAS
    Q, T, lens, band, tlens = _full_pallas_inputs()
    res = extd2_batch_pallas(jnp.asarray(Q), jnp.asarray(T), jnp.asarray(lens),
                             jnp.asarray(band), PARAMS, Lmax, tlens=jnp.asarray(tlens),
                             Lt=Lt, interpret=True)
    for key, a in zip(("score", "dirs", "offs", "off_ends"), res):
        arrays[f"full_width/{key}"] = np.asarray(a)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """Each case's inputs, the Pallas kernel's outputs (from the subprocess)
    and the JAX windowed backtrack of those dirs."""
    import jax.numpy as jnp

    from gdiet_tpu.pipeline.device_step import _backtrack_antidiag

    tmp = tmp_path_factory.mktemp("band")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_disable_hlo_passes=fusion",
           "JAX_COMPILATION_CACHE_DIR": str(tmp / "jax_cache")}
    res = subprocess.run([sys.executable, "-m", "tests.test_torch_band", str(tmp / "p.npz")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    z = np.load(tmp / "p.npz")
    out = {}
    for name, (_, _, Lmax, Lt, bb, U) in CASES.items():
        Q, T, lens, band, tlens = inp = _inputs(name)
        ref = [z[f"{name}/{key}"] for key in ("score", "dirs", "offs", "off_ends")]
        bt = _backtrack_antidiag(jnp.asarray(ref[1]), jnp.asarray(lens), jnp.asarray(band),
                                 Lmax, tlens=jnp.asarray(tlens), Lt=Lt, band_budget=bb,
                                 unroll=U)
        out[name] = (inp, ref, [np.asarray(a) for a in bt])
    out["full_width"] = (_full_pallas_inputs(),
                         [z[f"full_width/{key}"] for key in ("score", "dirs", "offs", "off_ends")],
                         None)
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_window_geometry_matches_jax():
    from gdiet_tpu.ops import dp_pallas

    for unroll in (4, 8):
        for band in (0, 1, 64, 200, 300, 500, 1000, 1300, 4000):
            for T in (128, 256, 384, 1024, 3072, 5120, 34048):
                assert (dp_band.window_geometry(band, T, unroll)
                        == dp_pallas.window_geometry(band, T, unroll))
    assert dp_band.DP_UNROLL == dp_pallas.DP_UNROLL


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_band_matches_pallas(pallas, case):
    _, N, Lmax, Lt, bb, U = CASES[case]
    (Q, T, lens, band, tlens), ref, _ = pallas[case]
    T_, R, WB = dp_band.band_shape(Lmax, Lt, bb, U)
    assert WB is not None and WB < T_
    calls, launches = dp_band.calls.n, extd2.band_launches.n
    got = extd2.extd2_batch(*_t(Q, T, lens, band), PARAMS, Lmax,
                            tlens=torch.from_numpy(tlens), Lt=Lt,
                            band_budget=bb, unroll=U)
    # CPU tensors take the plain banded version, never the kernel
    assert dp_band.calls.n == calls + 1 and extd2.band_launches.n == launches
    assert got[1].shape == (N, R, WB)
    for name, a, b in zip(("score", "dirs", "offs", "off_ends"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert (ref[0] > dp.NEG_INF).sum() >= N - 2  # most rows reach the corner


@pytest.mark.parametrize("case", sorted(CASES))
def test_band_backtrack_matches_jax(pallas, case):
    _, _, Lmax, Lt, bb, U = CASES[case]
    (Q, T, lens, band, tlens), ref, ref_bt = pallas[case]
    calls = backtrack.backtrack_calls.n
    got = extd2.backtrack_band(torch.from_numpy(ref[1]), *_t(lens, tlens, band),
                               Lmax, Lt, band_budget=bb, unroll=U)
    assert backtrack.backtrack_calls.n == calls + 1
    for name, a, b in zip(("ops", "fin_i", "fin_j"), got, ref_bt):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


# (N, Lmax, Lt, band budget) of the full-width case: band 100's window is
# not narrower than round128(128)
FULL_WIDTH = (4, 64, 128, 100)


def _full_width_inputs():
    rng = np.random.default_rng(3)
    N, Lmax, Lt, bb = FULL_WIDTH
    Q = rng.integers(0, 4, (N, Lmax), dtype=np.uint8)
    T = rng.integers(0, 4, (N, Lt), dtype=np.uint8)
    T[:, :Lmax] = Q
    lens = np.full(N, Lmax, np.int32)
    tlens = np.full(N, Lt - 7, np.int32)
    band = np.full(N, bb, np.int32)
    return Q, T, lens, band, tlens


def test_unwindowed_route_is_full_width():
    """Where the window would not be narrower than round128(Lt) (map-hifi's
    bw 1000 at the (512, 1024) bucket), extd2_batch runs the full-width DP
    and backtrack_band reads the full-width layout."""
    N, Lmax, Lt, bb = FULL_WIDTH
    Q, T, lens, band, tlens = _full_width_inputs()
    assert dp_band.window_geometry(bb, 128, 8) is None
    args = _t(Q, T, lens, band)
    got = extd2.extd2_batch(*args, PARAMS, Lmax, tlens=torch.from_numpy(tlens),
                            Lt=Lt, band_budget=bb, unroll=8)
    ref = dp.extd2_batch(*args, PARAMS, Lmax, torch.from_numpy(tlens), Lt)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    bt = extd2.backtrack_band(got[1], *_t(lens, tlens, band), Lmax, Lt,
                              band_budget=bb, unroll=8)
    ref_bt = backtrack.backtrack_antidiag(ref[1], args[2], args[3], Lmax,
                                            tlens=torch.from_numpy(tlens), Lt=Lt)
    for a, b in zip(bt, ref_bt):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES) + ["full_width"])
def test_pallas_dirs_end_at_last_wavefront(pallas, case):
    """In the Pallas kernel's own outputs, windowed and at full width,
    every dirs row r >= qlen+tlen-1 of a candidate and every row of a
    qlen-0 candidate is zero, and a qlen-0 candidate scores NEG_INF:
    extd2_band.cu and extd2.cu end each candidate at its last live
    wavefront and zero the rest."""
    (Q, T, lens, band, tlens), ref, _ = pallas[case]
    score, dirs = ref[0], ref[1]
    R = dirs.shape[1]
    assert len(set(band)) > 1 and (lens == 0).any()
    for n in range(len(lens)):
        r_end = lens[n] + tlens[n] - 1 if lens[n] > 0 else 0
        assert r_end < R
        assert not dirs[n, r_end:].any(), n
        if lens[n] == 0:
            assert score[n] == dp.NEG_INF


def _walk_reads(ops, qlen, tlen, w, Wd, T, WB, bb, U):
    """Replay the plain backtrack's walk from its op row: per step (r, i,
    the dirs column read, or None where the band forces the op), and the
    end point."""
    Rpad = ops.shape[0]
    i, j, steps = tlen - 1, qlen - 1, []
    while i >= 0 and j >= 0:
        r = i + j
        st0 = max(0, r - qlen + 1, (r - w + 1) >> 1)
        en0 = min(tlen - 1, r, (r + w) >> 1)
        live = st0 <= en0 and r < qlen + tlen - 1
        off_r = st0 // 16 * 16 if live else T
        off_end = min((en0 + 16) // 16 * 16 - 1, T - 1) if live else -1
        col = None
        if off_r <= i <= off_end:
            lo = 0 if WB is None else dp_band.window_base(r // U * U, bb, T, WB)
            col = min(max(i - lo, 0), Wd - 1)
        steps.append((r, i, col))
        op = int(ops[Rpad - 1 - r])
        assert op in (dp.CIGAR_MATCH, dp.CIGAR_INS, dp.CIGAR_DEL)
        i -= op != dp.CIGAR_INS
        j -= op != dp.CIGAR_DEL
    return steps, (i, j)


@pytest.mark.parametrize("K", [4, 32])
@pytest.mark.parametrize("case", sorted(CASES) + ["full_width"])
def test_backtrack_tile_covers_walk(request, case, K):
    """Every dirs byte the plain walk reads in a K-step window lies in
    backtrack_tile of the walk's position at the window's start, for
    windows starting every K/2 steps (the kernel stages a K-step tile every
    K/2 steps and walks it over the next K); at K = 32 each row's columns,
    widened to 16-byte chunks, fit the kernel's 48-byte tile slot."""
    if case == "full_width":
        N, Lmax, Lt, bb = FULL_WIDTH
        U = dp_band.LR_UNROLL
        Q, T, lens, band, tlens = _full_width_inputs()
        dirs = dp.extd2_batch(*_t(Q, T, lens, band), PARAMS, Lmax,
                              torch.from_numpy(tlens), Lt)[1]
    else:
        _, N, Lmax, Lt, bb, U = CASES[case]
        (Q, T, lens, band, tlens), ref, _ = request.getfixturevalue("pallas")[case]
        dirs = torch.from_numpy(ref[1])
    ops, fin_i, fin_j = extd2.backtrack_band(dirs, *_t(lens, tlens, band), Lmax, Lt,
                                             band_budget=bb, unroll=U)
    Wd, T_ = dirs.shape[2], dp.round_up(Lt, 128)
    WB = dp_band.window_geometry(bb, T_, U)
    assert (WB is None) == (case == "full_width")
    checked = 0
    for n in range(N):
        steps, end = _walk_reads(ops[n].numpy(), int(lens[n]), int(tlens[n]),
                                 int(band[n]), Wd, T_, WB, bb, U)
        assert end == (int(fin_i[n]), int(fin_j[n]))
        for b in range(0, len(steps), K // 2):
            r0, i0, _ = steps[b]
            r_lo, r_hi, col_lo, col_hi = dp_band.backtrack_tile(r0, i0, K, Wd, T_, WB, bb, U)
            if K == 32:
                assert max(h - (l & ~15) for l, h in zip(col_lo, col_hi)) < 48
            for r, _, col in steps[b: b + K]:
                if col is None:
                    continue
                assert r_lo <= r <= r_hi, (n, b, r)
                assert col_lo[r - r_lo] <= col <= col_hi[r - r_lo], (n, b, r, col)
                checked += 1
    assert checked > 100


def _cuda_inputs(kind, N, Lmax, Lt):
    """``mixed``: _pairs's windows; ``staggered``: qlen spread from 1 to
    Lmax, so that the candidates end at widely different wavefronts;
    ``dead``: every qlen 0."""
    Q, T, lens, tlens = _pairs(11, N, Lmax, Lt)
    if kind == "staggered":
        rng = np.random.default_rng(12)
        lens = rng.integers(1, Lmax + 1, N).astype(np.int32)
        lens[:2] = (1, Lmax)
        tlens = np.minimum(lens + rng.integers(0, 65, N), Lt).astype(np.int32)
    elif kind == "dead":
        lens[:] = 0
    return Q, T, lens, tlens


@pytest.mark.cuda
@pytest.mark.parametrize("bb,Lmax,Lt,kind,N", [
    (64, 256, 512, "mixed", 40),
    (500, 2048, 3072, "staggered", 40),
    (500, 512, 3072, "dead", 8),
    (1300, 512, 3072, "mixed", 40),
    (3900, 1024, 4224, "staggered", 12),
    (1000, 512, 1024, "mixed", 40),
    (1000, 512, 1024, "staggered", 40)])
def test_cuda_band_kernels_match_plain(bb, Lmax, Lt, kind, N):
    """The band kernel (two lanes per thread at WB 256 to 1,536, four at WB
    4,096), or extd2.cu at 1,024 threads where band 1000
    leaves the (512, 1024) bucket unwindowed, and the backtrack kernel on
    the windowed and the full-width layouts, against their plain versions,
    exact; staggered lengths end the candidates at different wavefronts, a
    dead chunk ends them all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    Q, T, lens, tlens = _cuda_inputs(kind, N, Lmax, Lt)
    band = np.full(N, bb, np.int32)
    args = [a.cuda() for a in _t(Q, T, lens, band)]
    tl = torch.from_numpy(tlens).cuda()
    windowed = dp_band.window_geometry(bb, dp.round_up(Lt, 128), 8) is not None
    count = extd2.band_launches if windowed else extd2.launches
    launches = count.n
    got = extd2.extd2_batch(*args, PARAMS, Lmax, tlens=tl, Lt=Lt, band_budget=bb, unroll=8)
    torch.cuda.synchronize()
    assert count.n == launches + 1
    ref = (dp_band.extd2_band(*args, PARAMS, Lmax, tl, Lt, bb, 8) if windowed
           else dp.extd2_batch(*args, PARAMS, Lmax, tl, Lt))
    # score and dirs; the card leaves offs and off_ends to dp.band_geometry
    assert got[2] is None and got[3] is None
    for a, b in zip(ref[:2], got[:2]):
        assert torch.equal(a, b)
    launches = extd2.backtrack_launches.n
    bt = extd2.backtrack_band(got[1], args[2], tl, args[3], Lmax, Lt, band_budget=bb, unroll=8)
    torch.cuda.synchronize()
    assert extd2.backtrack_launches.n == launches + 1
    ref_bt = backtrack.backtrack_antidiag(got[1], args[2], args[3], Lmax, tlens=tl,
                                            Lt=Lt, band_budget=bb, unroll=8)
    for a, b in zip(ref_bt, bt):
        assert torch.equal(a, b)


if __name__ == "__main__":
    run_pallas(sys.argv[1])
