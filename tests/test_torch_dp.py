"""Port DP vs gdiet_tpu.ops.dp.extd2_batch (the plain reference of the
Pallas kernel), bit for bit: score (NEG_INF rows included), the whole dirs
tensor, offs and off_ends. The CUDA kernels (unfolded and folded, and the
backtrack kernel on the unfolded dirs) are held against their plain
versions on a card; without one those cases skip.

JAX is imported inside the tests that use it, so that the CUDA case also
runs on a GPU host without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_dp.py``.
"""

import random

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import dp, dp_fold, extd2
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


LMAX = 96


def _cases(seed, N=40, Lmax=LMAX, Lt=None):
    """Seeded (query, target) windows: substitutions, indels, N bases,
    random pairs, empty rows, and varied bands."""
    Lt = Lt or Lmax
    random.seed(seed)
    rng = np.random.default_rng(seed)
    Q = np.zeros((N, Lmax), np.uint8)
    T = np.zeros((N, Lt), np.uint8)
    lens = np.zeros(N, np.int32)
    tlens = np.zeros(N, np.int32)
    band = np.zeros(N, np.int32)
    for i in range(N):
        L = random.randrange(2, min(Lmax, Lt))
        q = rng.integers(0, 5 if i % 4 == 0 else 4, L).astype(np.uint8)
        if i % 6 == 0:
            t = rng.integers(0, 4, L).astype(np.uint8)
        else:
            t = q.copy()
            for _ in range(random.randrange(0, 8)):
                j = random.randrange(0, max(1, len(t) - 1))
                op = random.random()
                if op < 0.5:
                    t[j] = random.randrange(5)
                elif op < 0.75:
                    t = np.insert(t, j, random.randrange(4))[:L]
                elif len(t) > 1:
                    t = np.delete(t, j)
            t = np.concatenate([t, rng.integers(0, 4, L)])[:L].astype(np.uint8)
        tl = L if Lt == Lmax else min(Lt, L + random.randrange(0, 9))
        t = np.concatenate([t, rng.integers(0, 4, tl)])[:tl]
        Q[i, :L], T[i, :tl], lens[i], tlens[i] = q, t, L, tl
        band[i] = random.choice([3, 10, 37, 150])
    lens[::9] = 0  # dead rows score NEG_INF
    return Q, T, lens, tlens, band


def _jax_extd2(Q, T, lens, band, prm, Lmax, tlens=None, Lt=None):
    import jax.numpy as jnp

    from gdiet_tpu.ops.dp import extd2_batch

    return extd2_batch(
        jnp.asarray(Q), jnp.asarray(T), jnp.asarray(lens), jnp.asarray(band),
        jnp.asarray(np.array(prm, np.int32)), Lmax,
        tlens=None if tlens is None else jnp.asarray(tlens), Lt=Lt)


def _check(ref, got):
    for name, a, b in zip(("score", "dirs", "offs", "off_ends"), ref, got):
        np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("prm", [(2, 8, 12, 2, 24, 1), (1, 4, 6, 2, 26, 1),
                                 (2, 4, 24, 1, 12, 2)])
def test_plain_matches_jax(prm):
    Q, T, lens, _, band = _cases(sum(prm))
    ref = _jax_extd2(Q, T, lens, band, prm, LMAX)
    assert (np.asarray(ref[0]) == dp.NEG_INF).any()
    calls, launches = dp.calls.n, extd2.launches.n
    got = extd2.extd2_batch(torch.from_numpy(Q), torch.from_numpy(T),
                            torch.from_numpy(lens), torch.from_numpy(band), prm, LMAX)
    _check(ref, got)
    # CPU tensors take the plain version, never the kernel
    assert dp.calls.n == calls + 1 and extd2.launches.n == launches


def test_plain_matches_jax_separate_target_budget():
    prm, Lt = (2, 8, 12, 2, 24, 1), 120
    Q, T, lens, tlens, band = _cases(5, Lt=Lt)
    ref = _jax_extd2(Q, T, lens, band, prm, LMAX, tlens=tlens, Lt=Lt)
    got = dp.extd2_batch(torch.from_numpy(Q), torch.from_numpy(T),
                         torch.from_numpy(lens), torch.from_numpy(band), prm,
                         LMAX, tlens=torch.from_numpy(tlens), Lt=Lt)
    _check(ref, got)


def test_band_geometry_closed_form():
    Q, T, lens, _, band = _cases(9)
    prm = (2, 8, 12, 2, 24, 1)
    _, _, offs, off_ends = dp.extd2_batch(
        torch.from_numpy(Q), torch.from_numpy(T), torch.from_numpy(lens),
        torch.from_numpy(band), prm, LMAX)
    o2, e2 = dp.band_geometry(torch.from_numpy(lens), None, torch.from_numpy(band),
                              2 * LMAX - 1, dp.round16(LMAX))
    assert torch.equal(offs, o2) and torch.equal(off_ends, e2)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    prm = (2, 8, 12, 2, 24, 1)
    Q, T, lens, _, band = _cases(13, N=300, Lmax=160)
    args = [torch.from_numpy(a).cuda() for a in (Q, T, lens, band)]
    launches = extd2.launches.n
    got = extd2.extd2_batch(*args, prm, 160)
    torch.cuda.synchronize()
    assert extd2.launches.n == launches + 1
    ref = dp.extd2_batch(*args, prm, 160)
    assert got[2] is None and got[3] is None
    for a, b in zip(ref[:2], got[:2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,Lmax,Lt", [(400, 160, None), (40, LMAX, 120)])
def test_cuda_fold_kernel_matches_plain(N, Lmax, Lt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    prm = (2, 8, 12, 2, 24, 1)
    Q, T, lens, tlens, band = _cases(17, N=N, Lmax=Lmax, Lt=Lt)
    args = [torch.from_numpy(a).cuda() for a in (Q, T, lens, band)]
    tl = torch.from_numpy(tlens).cuda() if Lt else None
    launches = extd2.fold_launches.n
    got = extd2.extd2_batch(*args, prm, Lmax, tlens=tl, Lt=Lt, fold=True)
    torch.cuda.synchronize()
    assert extd2.fold_launches.n == launches + 1
    ref = dp_fold.extd2_fold(*args, prm, Lmax, tlens=tl, Lt=Lt)
    assert got[2] is None and got[3] is None
    for a, b in zip(ref[:2], got[:2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,Lmax,Lt,kind", [
    (6272, 160, None, "staggered"), (400, 160, None, "dead"), (300, 512, None, "staggered"),
    (200, 96, 120, "staggered"), (64, 64, 600, "staggered")])
def test_cuda_kernel_and_backtrack_match_plain(N, Lmax, Lt, kind):
    """extd2.cu (the warp route up to 512 lanes, the block route at 608)
    and the backtrack kernel on its full-width dirs, as the short-read step
    calls it (tlens = qlens where the target budget is the query's),
    against their plain versions, exact: at the main path's 6,272 x 160,
    with staggered lengths (2..Lmax, every ninth row dead) and an all-dead
    chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from gdiet_tpu_torch.ops.backtrack import backtrack_antidiag

    prm = (2, 8, 12, 2, 24, 1)
    Q, T, lens, tlens, band = _cases(19, N=N, Lmax=Lmax, Lt=Lt)
    if kind == "dead":
        lens[:] = 0
    q, t, ln, bd = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
    tl = torch.from_numpy(tlens).cuda() if Lt else None
    launches = extd2.launches.n
    got = extd2.extd2_batch(q, t, ln, bd, prm, Lmax, tlens=tl, Lt=Lt)
    torch.cuda.synchronize()
    assert extd2.launches.n == launches + 1
    ref = dp.extd2_batch(q, t, ln, bd, prm, Lmax, tlens=tl, Lt=Lt)
    # score and dirs; the card leaves offs and off_ends to dp.band_geometry
    assert got[2] is None and got[3] is None
    for a, b in zip(ref[:2], got[:2]):
        assert torch.equal(a, b)
    launches = extd2.backtrack_launches.n
    bt = extd2.backtrack_band(got[1], ln, ln if tl is None else tl, bd, Lmax, Lt or Lmax)
    torch.cuda.synchronize()
    assert extd2.backtrack_launches.n == launches + 1
    ref_bt = backtrack_antidiag(got[1], ln, bd, Lmax, tlens=tl, Lt=Lt)
    for a, b in zip(ref_bt, bt):
        assert torch.equal(a, b)
