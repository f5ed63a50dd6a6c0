"""Port folded DP vs gdiet_tpu's Pallas fold kernel, bit for bit, on the CPU.

The fold has no plain-XLA reference, so the port's plain fold version
(``ops/dp_fold.py::extd2_fold``) is held against ``extd2_batch_pallas(...,
fold=True, interpret=True)``: score, the whole raw folded dirs, offs and
off_ends, exact. The port's folded backtrack, plain and through
``extd2.backtrack_band(fold=True)``, is held against
``_backtrack_antidiag(fold=True)`` on those dirs, and
``dp_band.backtrack_tile`` against every byte the folded walk reads (the
rule ``csrc/backtrack_band.cu`` stages its tiles by). One case runs C = 3
passes, so two candidates are live in one kernel row at the same time; one
has target lengths and a target budget other than the query's. Each JAX
interpret call runs once per module.

JAX is imported inside the tests that use it, so that the ``cuda`` cases
(the fold kernel and the backtrack kernel on its dirs against their plain
versions) also run on a GPU host without JAX: ``python -m pytest
--noconftest -m cuda tests/test_torch_fold.py``.
"""

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import dp, dp_band, dp_fold, extd2
from gdiet_tpu_torch.pipeline import device_step
from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


PARAMS = (2, 8, 12, 2, 24, 1)


def _pairs(seed, N, Lmax, Lt):
    """Equal, mutated and unrelated pairs with N codes, dead rows and
    bands from 1 to 80."""
    rng = np.random.default_rng(seed)
    L = min(Lmax, Lt)
    Q = rng.integers(0, 4, (N, Lmax), dtype=np.uint8)
    T = rng.integers(0, 4, (N, Lt), dtype=np.uint8)
    for n in range(0, N, 3):
        T[n, :L] = Q[n, :L]
    for n in range(1, N, 3):
        T[n, :L] = Q[n, :L]
        for p in rng.integers(0, L, 3):
            T[n, p] = (T[n, p] + 1) % 4
    Q[rng.random(Q.shape) < 0.02] = 4
    T[rng.random(T.shape) < 0.02] = 4
    lens = rng.integers(1, Lmax + 1, N).astype(np.int32)
    lens[5::11] = 0
    tlens = None if Lt == Lmax else rng.integers(1, Lt + 1, N).astype(np.int32)
    band = rng.integers(1, 81, N).astype(np.int32)
    return Q, T, lens, band, tlens


CASES = {"multipass": (3, 400, 40, 40), "tlens": (13, 12, 24, 48)}


@pytest.fixture(scope="module")
def pallas():
    """Each case through the Pallas fold kernel in interpret mode and the
    JAX folded backtrack, once."""
    import jax.numpy as jnp

    from gdiet_tpu.ops.dp_pallas import extd2_batch_pallas
    from gdiet_tpu.pipeline.device_step import _backtrack_antidiag

    out = {}
    for name, (seed, N, Lmax, Lt) in CASES.items():
        Q, T, lens, band, tlens = inp = _pairs(seed, N, Lmax, Lt)
        jt = None if tlens is None else jnp.asarray(tlens)
        res = extd2_batch_pallas(
            jnp.asarray(Q), jnp.asarray(T), jnp.asarray(lens), jnp.asarray(band),
            PARAMS, Lmax, tlens=jt, Lt=Lt, interpret=True, fold=True)
        bt = _backtrack_antidiag(res[1], jnp.asarray(lens), jnp.asarray(band), Lmax,
                                 tlens=jt, Lt=Lt, fold=True)
        out[name] = (inp, [np.asarray(a) for a in res], [np.asarray(a) for a in bt])
    return out


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fold_matches_pallas(pallas, case):
    _, N, Lmax, Lt = CASES[case]
    (Q, T, lens, band, tlens), ref, _ = pallas[case]
    calls, launches = dp_fold.calls.n, extd2.fold_launches.n
    got = extd2.extd2_batch(_torch(Q), _torch(T), _torch(lens), _torch(band),
                            PARAMS, Lmax, tlens=_torch(tlens), Lt=Lt, fold=True)
    # CPU tensors take the plain fold version, never the kernel
    assert dp_fold.calls.n == calls + 1 and extd2.fold_launches.n == launches
    for name, a, b in zip(("score", "dirs", "offs", "off_ends"), ref, got):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    H, Tf, _ = dp_fold.fold_geometry(Lmax, Lt)
    _, Nrows, C = dp_fold.fold_split(N, Tf)
    assert got[1].shape == ((C + 1) * H, Nrows, Tf)
    if case == "multipass":
        assert C == 3
        # candidates of consecutive passes share kernel rows
        assert (lens[:Nrows] > 0).any() and (lens[Nrows:2 * Nrows] > 0).any()
    assert (ref[0] == dp_fold.dp.NEG_INF).any() and (ref[0] > 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_backtrack_matches_jax(pallas, case):
    _, _, Lmax, Lt = CASES[case]
    (_, _, lens, band, tlens), ref, bt = pallas[case]
    got = backtrack_antidiag(torch.from_numpy(ref[1].copy()), _torch(lens), _torch(band),
                             Lmax, tlens=_torch(tlens), Lt=Lt, fold=True)
    for name, a, b in zip(("ops", "fin_i", "fin_j"), bt, got):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert (bt[0] != 255).any()


def test_fold_geometry_matches_jax():
    from gdiet_tpu.ops import dp_pallas

    for Lmax in (16, 24, 40, 64, 96, 128, 160, 256, 304):
        for Lt in (Lmax, Lmax + 24, 2 * Lmax, 1000):
            assert dp_fold.fold_geometry(Lmax, Lt) == dp_pallas.fold_geometry(Lmax, Lt)
            assert dp_fold.fold_geometry(Lmax, Lt, 8) == dp_pallas.fold_geometry(Lmax, Lt, 8)
    for band in (0, 50, 150, 200, 500, 2000):
        for T in (128, 256, 384, 512, 1024):
            assert dp_fold.window_geometry(band, T) == dp_pallas.window_geometry(band, T)
    for T in (128, 256, 384, 1024, 4096):
        for N in (0, 1, 37, 192, 400, 3072, 6272, 20000):
            NB = max(8, min(192, (10 << 19) // ((7 * 4 + 8) * T) // 16 * 16))
            Nrows = dp_pallas._round_up(max(1, -(-N // dp_pallas.FOLD_PASSES)), NB)
            assert dp_fold.fold_split(N, T) == (NB, Nrows, max(1, -(-N // Nrows)))
    assert (dp_fold.FOLD_GAP, dp_fold.FOLD_PASSES, dp_fold.DP_UNROLL) == (
        dp_pallas.FOLD_GAP, dp_pallas.FOLD_PASSES, dp_pallas.DP_UNROLL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_backtrack_band_matches_jax(pallas, case):
    """``extd2.backtrack_band(fold=True)``, the short-read step's call, runs
    the plain folded walk for CPU tensors (no kernel launch) and equals
    ``_backtrack_antidiag(fold=True)``."""
    _, _, Lmax, Lt = CASES[case]
    (_, _, lens, band, tlens), ref, bt = pallas[case]
    tl = lens if tlens is None else tlens
    calls, launches = device_step.backtrack_calls.n, extd2.backtrack_launches.n
    got = extd2.backtrack_band(torch.from_numpy(ref[1].copy()), _torch(lens), _torch(tl),
                               _torch(band), Lmax, Lt, fold=True)
    assert device_step.backtrack_calls.n == calls + 1
    assert extd2.backtrack_launches.n == launches
    for name, a, b in zip(("ops", "fin_i", "fin_j"), bt, got):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def _fold_walk_reads(ops, qlen, tlen, w, Wd, Tn, H):
    """Replay the plain folded walk from its op row: per step (r, i, the
    dirs column read in the candidate's row r, or None where the band
    forces the op), and the end point."""
    Rpad = ops.shape[0]
    i, j, steps = tlen - 1, qlen - 1, []
    while i >= 0 and j >= 0:
        r = i + j
        st0 = max(0, r - qlen + 1, (r - w + 1) >> 1)
        en0 = min(tlen - 1, r, (r + w) >> 1)
        live = st0 <= en0 and r < qlen + tlen - 1
        off_r = st0 // 16 * 16 if live else Tn
        off_end = min((en0 + 16) // 16 * 16 - 1, Tn - 1) if live else -1
        col = None
        if off_r <= i <= off_end:
            col = min(max(i - dp_band.lane_offset(r, Tn, H=H), 0), Wd - 1)
        steps.append((r, i, col))
        op = int(ops[Rpad - 1 - r])
        assert op in (dp.CIGAR_MATCH, dp.CIGAR_INS, dp.CIGAR_DEL)
        i -= op != dp.CIGAR_INS
        j -= op != dp.CIGAR_DEL
    return steps, (i, j)


@pytest.mark.parametrize("K", [4, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backtrack_tile_covers_fold_walk(pallas, case, K):
    """Every dirs byte the plain folded walk reads in a K-step window lies
    in ``backtrack_tile(..., H=H)`` of the walk's position at the window's
    start (rows at or past H shifted by the fold's lane gap), for windows
    starting every K/2 steps; at K = 32 each row's columns, widened to
    16-byte chunks, fit the kernel's 48-byte tile slot. Some windows
    straddle H."""
    _, N, Lmax, Lt = CASES[case]
    (_, _, lens, band, tlens), _, (ops, fin_i, fin_j) = pallas[case]
    tl = lens if tlens is None else tlens
    H, Wd, Tn = dp_fold.fold_geometry(Lmax, Lt)
    checked = straddled = 0
    for n in range(N):
        steps, end = _fold_walk_reads(ops[n], int(lens[n]), int(tl[n]), int(band[n]),
                                      Wd, Tn, H)
        assert end == (int(fin_i[n]), int(fin_j[n]))
        for b in range(0, len(steps), K // 2):
            r0, i0, _ = steps[b]
            r_lo, r_hi, col_lo, col_hi = dp_band.backtrack_tile(r0, i0, K, Wd, Tn, H=H)
            if K == 32:
                assert max(h - (lo & ~15) for lo, h in zip(col_lo, col_hi)) < 48
            for r, _, col in steps[b: b + K]:
                if col is None:
                    continue
                assert r_lo <= r <= r_hi, (n, b, r)
                assert col_lo[r - r_lo] <= col <= col_hi[r - r_lo], (n, b, r, col)
                straddled += (r0 >= H) != (r >= H)
                checked += 1
    assert checked > 100 and straddled > 0


def _cuda_fold_inputs(kind, N, Lmax, Lt):
    """``staggered``: _pairs's rows (qlen 1..Lmax, bands 1-80, N codes,
    dead rows); ``sr``: short-read windows of qlen Lmax-10..Lmax at the sr
    preset's bands 150-200; ``dead``: every qlen 0."""
    Q, T, lens, band, tlens = _pairs(21, N, Lmax, Lt)
    if kind == "sr":
        rng = np.random.default_rng(22)
        lens = rng.integers(Lmax - 10, Lmax + 1, N).astype(np.int32)
        lens[::97] = 0
        band = rng.integers(150, 201, N).astype(np.int32)
        T[:, : min(Lmax, Lt)] = Q[:, : min(Lmax, Lt)]
    elif kind == "dead":
        lens[:] = 0
    return Q, T, lens, band, tlens


@pytest.mark.cuda
@pytest.mark.parametrize("N,Lmax,Lt,kind", [
    (5120, 160, 160, "sr"), (400, 160, 160, "staggered"), (400, 160, 160, "dead"),
    (60, 40, 88, "staggered"), (300, 304, 304, "staggered"), (100, 512, 512, "staggered")])
def test_cuda_fold_and_backtrack_match_plain(N, Lmax, Lt, kind):
    """The fold kernel (the warp route up to 512 lanes, the block route at
    Lmax 512) and the backtrack kernel on its folded dirs, against their
    plain versions, exact: at the PE batch's 5,120 rows, with staggered
    lengths, an all-dead chunk and a target budget other than the query's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    Q, T, lens, band, tlens = _cuda_fold_inputs(kind, N, Lmax, Lt)
    q, t, ln, bd = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
    tl = None if tlens is None else torch.from_numpy(tlens).cuda()
    launches = extd2.fold_launches.n
    got = extd2.extd2_batch(q, t, ln, bd, PARAMS, Lmax, tlens=tl, Lt=Lt, fold=True)
    torch.cuda.synchronize()
    assert extd2.fold_launches.n == launches + 1
    ref = dp_fold.extd2_fold(q, t, ln, bd, PARAMS, Lmax, tlens=tl, Lt=Lt)
    # score and dirs; the card leaves offs and off_ends to dp.band_geometry
    assert got[2] is None and got[3] is None
    for a, b in zip(ref[:2], got[:2]):
        assert torch.equal(a, b)
    launches = extd2.backtrack_launches.n
    bt = extd2.backtrack_band(got[1], ln, ln if tl is None else tl, bd, Lmax, Lt, fold=True)
    torch.cuda.synchronize()
    assert extd2.backtrack_launches.n == launches + 1
    ref_bt = backtrack_antidiag(got[1], ln, bd, Lmax, tlens=tl, Lt=Lt, fold=True)
    for a, b in zip(ref_bt, bt):
        assert torch.equal(a, b)
