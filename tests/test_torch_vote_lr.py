"""The long-read votes: the port's plain loops (``lr_step._vote_scan_lr``,
``lr_step._vote2_scan``) vs gdiet_tpu's, the halves-in-place wrappers of
``ops/vote.py`` on the CPU vs the plain loops on the concatenated stream,
and ``csrc/vote_lr.cu`` vs the plain loops on the card (seeded streams,
ONT-sized halves and ``test_torch_vote_lr_warp.py``'s trap streams).

Seeded hit streams made with numpy, laid out as the long-read front lays
them out (forward hits, a barrier column, reverse hits, a barrier column;
M = 2(A+1)): clusters of hits whose counts repeat (tied scores) and
outnumber the slots (full lists), query spans one below, at and one above
the row's coverage threshold (the gate), the same locus on both sides of
the barrier (a run broken by the strand and the barrier), rows whose keys
are out of order within a run (t - ref_loc wraps) or small enough that the
raw target wraps, invalid holes inside a half, rows with no valid hit, and
empty round-2 windows (lo = hi = 0). Tolerance: exact, on every output.

JAX is imported inside the tests that use it, so that the CUDA cases also
run on a GPU host without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_vote_lr.py``.
"""

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import vote
from gdiet_tpu_torch.pipeline import lr_step
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
ROUND2 = ("b_score", "b_fq", "b_lq", "b_str", "b_first_t", "b_last_t")


def lr_streams(B: int, A: int, seed: int, holes: bool = True) -> dict:
    """A seeded long-read hit stream of B reads, A columns per half. With
    ``holes=False`` the valid columns of each half come first (the
    precondition of ``ops/vote.py`` and of ``lr_step._stream_columns``)."""
    rng = np.random.default_rng(seed)
    M = 2 * (A + 1)
    keys = np.full((B, M), U64_MAX, np.uint64)
    qpos = np.zeros((B, M), np.int32)
    valid = np.zeros((B, M), bool)
    cov = rng.integers(2, 30, B).astype(np.int32)
    for b in range(B):
        if b % 9 == 4:
            continue  # no valid hit
        shared = None
        for s in range(2):
            ks, qs = [], []
            base = np.uint64(int(rng.integers(0, 3)) << 32)
            if b % 4 == 1:  # small keys: the forward raw target wraps
                base = np.uint64(int(rng.integers(0, 200)))
            elif b % 7 == 3:  # near the top of the u64 range
                base = np.uint64(0xFFFFFFFF00000000)
            pos = int(rng.integers(0, 1000 if b % 4 == 1 else 1 << 20))
            for _ in range(int(rng.integers(1, max(9, A // 40)))):
                n = int(rng.choice([2, 3, 3, 4, 6]))  # repeated counts: ties
                span = int(cov[b]) + int(rng.choice([-1, 0, 1, 1, 5, 10]))  # the gate
                q0 = int(rng.integers(0, 250))
                q = q0 + np.sort(rng.integers(0, span + 1, n))
                q[0], q[-1] = q0, q0 + span
                rng.shuffle(q)
                ks += [base + np.uint64(pos + int(d)) for d in np.sort(rng.integers(0, 40, n))]
                qs += list(q)
                pos += int(rng.integers(2000, 20000))  # beyond any vt_distance
            n = min(len(ks), A)
            k = np.array(ks[:n], np.uint64)
            if b % 4 == 2 and n:  # the same locus on both sides of the barrier
                if shared is None:
                    shared = k[-1]
                else:
                    k[0] = shared
            if b % 6 == 5 and n > 3:  # out of order within a run: t - ref wraps
                k[[1, 2]] = k[[2, 1]]
            off = s * (A + 1)
            keys[b, off:off + n] = k
            qpos[b, off:off + n] = qs[:n]
            valid[b, off:off + n] = True
            if holes and b % 3 == 1 and n:
                valid[b, off:off + n] &= rng.random(n) >= 0.1
    strand = np.array([0] * (A + 1) + [1] * (A + 1), np.int32)
    lo1 = np.zeros(B, np.int32)
    hi1 = rng.integers(0, 300, B).astype(np.int32)
    lo2 = rng.integers(0, 200, B).astype(np.int32)
    hi2 = (lo2 + rng.integers(1, 150, B)).astype(np.int32)
    hi1[::5] = 0  # empty windows
    lo2[1::5] = hi2[1::5] = 0
    return {"keys": keys, "qpos": qpos, "valid": valid, "strand": strand,
            "extracted": rng.integers(200, 6000, B).astype(np.int64),
            "vt_distance": rng.integers(0, 700, B).astype(np.uint64), "cov_thr": cov,
            "lo1": lo1, "hi1": hi1, "lo2": lo2, "hi2": hi2}


def _t(a, device="cpu"):
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a).to(device)


def halves(s: dict, device="cpu", pad: int = 0) -> list:
    """(fk, fq, fok, rk, rq, rok) of a stream, as column views of [B, A +
    pad] tensors (row stride A + pad, as the front's vote_budget slice)."""
    A = (s["keys"].shape[1] - 2) // 2
    out = []
    for name in ("keys", "qpos", "valid"):
        for off in (0, A + 1):
            a = s[name][:, off:off + A]
            wide = np.concatenate([a, np.zeros((a.shape[0], pad), a.dtype)], 1)
            out.append(_t(np.ascontiguousarray(wide), device)[:, :A])
    fk, rk, fq, rq, fok, rok = out
    return [fk, fq, fok, rk, rq, rok]


def plain_round1(s: dict, K: int, device="cpu") -> dict:
    t = {n: _t(s[n], device) for n in ("keys", "qpos", "valid", "extracted",
                                       "vt_distance", "cov_thr")}
    return lr_step._vote_scan_lr(t["keys"], t["qpos"], t["valid"], s["strand"].tolist(),
                                 t["extracted"], t["vt_distance"], t["cov_thr"], K,
                                 list(range(s["keys"].shape[1])))


def plain_pair(s: dict, device="cpu") -> torch.Tensor:
    t = {n: _t(s[n], device) for n in ("keys", "qpos", "valid", "extracted",
                                       "vt_distance", "lo1", "hi1", "lo2", "hi2")}
    return lr_step.vote2_packed_pair(t["keys"], t["qpos"], t["valid"], s["strand"].tolist(),
                                     t["extracted"], t["vt_distance"], t["lo1"], t["hi1"],
                                     t["lo2"], t["hi2"], list(range(s["keys"].shape[1])))


def _jax_args(s: dict):
    import jax.numpy as jnp

    return [jnp.asarray(s[n]) for n in ("keys", "qpos", "valid", "strand", "extracted",
                                        "vt_distance")]


@pytest.mark.parametrize("K,seed", [(1, 21), (5, 22)])
def test_plain_round1_matches_jax(K, seed):
    import jax.numpy as jnp

    from gdiet_tpu.pipeline.lr_step import _vote_scan_lr

    s = lr_streams(48, 40, seed)
    ref = _vote_scan_lr(*_jax_args(s), jnp.asarray(s["cov_thr"]), K=K)
    calls = lr_step.vote_calls.n
    got = plain_round1(s, K)
    assert lr_step.vote_calls.n == calls + 1
    for name in vote.LR_OUTPUTS:
        want = np.asarray(ref[name])
        have = got[name].numpy()
        if name.endswith("_t"):
            have = have.view(np.uint64)
        assert have.dtype == want.dtype and np.array_equal(have, want), name
    out_len, score = got["out_len"].numpy(), got["k_score"].numpy()
    assert (out_len == K).any()  # full lists
    assert (out_len == 0).any() and (~s["valid"]).all(1).any()
    if K > 1:  # tied scores among the kept slots
        filled = np.arange(K)[None, 1:] < out_len[:, None]
        assert (filled & (score[:, 1:] == score[:, :-1])).any()


def test_plain_round2_matches_jax():
    import jax.numpy as jnp

    from gdiet_tpu.pipeline.lr_step import _vote2_scan

    s = lr_streams(48, 40, 23)
    t = {n: _t(s[n]) for n in ("keys", "qpos", "valid", "extracted", "vt_distance")}
    calls = lr_step.vote_calls.n
    for lo, hi in (("lo1", "hi1"), ("lo2", "hi2")):
        ref = _vote2_scan(*_jax_args(s), jnp.asarray(s[lo]), jnp.asarray(s[hi]))
        got = lr_step._vote2_scan(t["keys"], t["qpos"], t["valid"], s["strand"].tolist(),
                                  t["extracted"], t["vt_distance"], _t(s[lo]), _t(s[hi]),
                                  list(range(s["keys"].shape[1])))
        for name in ROUND2:
            want = np.asarray(ref[name])
            have = got[name].numpy()
            if name.endswith("_t"):
                have = have.view(np.uint64)
            assert have.dtype == want.dtype and np.array_equal(have, want), (lo, name)
        empty = (s[hi] <= s[lo] + 1)
        assert empty.any() and (got["b_score"].numpy()[empty] == 0).all()
        assert (got["b_score"].numpy() > 0).sum() > 5
    assert lr_step.vote_calls.n == calls + 2


@pytest.mark.parametrize("K,pad", [(3, 5), (1, 0)])
def test_wrappers_on_cpu_equal_plain(K, pad):
    """vote_lr and vote2_pair on CPU halves of a valid-first stream (column
    views, row stride A + pad), whose plain loops visit only
    ``_stream_columns``, equal the plain loops over every column of the
    concatenated stream."""
    s = lr_streams(40, 60, 24 + K, holes=False)
    h = halves(s, pad=pad)
    assert h[0].stride(0) == 60 + pad
    per_row = [_t(s[n]) for n in ("extracted", "vt_distance")]
    launches, calls = vote.lr_launches.n, lr_step.vote_calls.n
    got1 = vote.vote_lr(*h, *per_row, _t(s["cov_thr"]), K)
    got2 = vote.vote2_pair(*h, *per_row, *(_t(s[n]) for n in ("lo1", "hi1", "lo2", "hi2")))
    assert vote.lr_launches.n == launches and lr_step.vote_calls.n == calls + 3
    want1 = plain_round1(s, K)
    for name in vote.LR_OUTPUTS:
        assert torch.equal(got1[name], want1[name]), name
    assert torch.equal(got2, plain_pair(s))
    assert len(lr_step._stream_columns(h[2], h[5])) < s["keys"].shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize("B,A,K,kind", [
    (256, 512, 5, "seeded"),  # the HiFi front's stream (vote budget 512, M = 1,026)
    (16, 4096, 3, "seeded"),  # the ONT front's stream (vote budget 4,096, M = 8,194)
    (300, 30, 1, "seeded"),
    (70, 40, 60, "seeded"),  # more slots than shared memory holds: slots in the outputs
    (16, 4096, 3, "ont_rows"),  # ONT-sized halves: a run of ~600 columns
    # tests/test_torch_vote_lr_warp.py's trap streams, at 1, 5 and 40 slots
    *[(0, 0, K, case) for case in ("cross_step", "q_tie_min", "wrap", "own_runs", "long_run",
                                   "full_lists", "empty_halves", "window_start")
      for K in (1, 5, 40)],
])
def test_cuda_kernel_matches_plain(B, A, K, kind):
    """Both kernels on valid-first halves in place (row stride A + 3)
    against the plain loops over every column of the concatenation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    if kind == "seeded":
        s = lr_streams(B, A, B + A + K, holes=False)
    else:
        import test_torch_vote_lr_warp as warp

        s = (warp.make_stream(warp.ont_rows(B, 7), 7, A) if kind == "ont_rows"
             else warp.make_stream(warp.case_rows(kind), 41))
    h = halves(s, "cuda", pad=3)
    per_row = [_t(s[n], "cuda") for n in ("extracted", "vt_distance")]
    windows = [_t(s[n], "cuda") for n in ("lo1", "hi1", "lo2", "hi2")]
    launches = vote.lr_launches.n
    got1 = vote.vote_lr(*h, *per_row, _t(s["cov_thr"], "cuda"), K)
    got2 = vote.vote2_pair(*h, *per_row, *windows)
    torch.cuda.synchronize()
    assert vote.lr_launches.n == launches + 2
    want1 = plain_round1(s, K, "cuda")
    for name in vote.LR_OUTPUTS:
        assert torch.equal(got1[name], want1[name]), name
    assert torch.equal(got2, plain_pair(s, "cuda"))
