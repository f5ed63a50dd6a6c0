"""Port folded DP vs gdiet_tpu's Pallas fold kernel, bit for bit, on the CPU.

The fold has no plain-XLA reference, so the port's plain fold version
(``ops/dp_fold.py::extd2_fold``) is held against ``extd2_batch_pallas(...,
fold=True, interpret=True)``: score, the whole raw folded dirs, offs and
off_ends, exact. The port's folded backtrack is held against
``_backtrack_antidiag(fold=True)`` on those dirs. One case runs C = 3
passes, so two candidates are live in one kernel row at the same time; one
has target lengths and a target budget other than the query's. Each JAX
interpret call runs once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdiet_tpu.ops import dp_pallas
from gdiet_tpu.ops.dp_pallas import extd2_batch_pallas
from gdiet_tpu.pipeline.device_step import _backtrack_antidiag
from gdiet_tpu_torch.ops import dp_fold, extd2
from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

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
