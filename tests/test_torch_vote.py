"""The short-read vote scan: the port's plain loop vs gdiet_tpu's
``_vote_scan``, ``ops/vote.py::vote_scan`` on CPU halves vs the plain loop
on their concatenation, and ``csrc/vote_scan.cu`` vs the plain loop.

Seeded hit streams made with numpy, laid out as the fused step lays them
out (forward hits sorted, a barrier column, reverse hits sorted, a barrier
column; M = 2(A+1)): clustered keys that make runs, invalid holes, keys
near the top of the uint64 range (unsigned distance), runs whose keys
straddle the strand barrier, stretches of columns with no valid hit in
any row, rows whose slot list fills up and rows left with only the
recovery candidate. The wrapper and the kernel take the two halves in
place (column views of wider tensors here); the kernel's streams have no
holes, so each half's valid columns come first, its precondition.
Tolerance: exact, on all 11 outputs.

JAX is imported inside the test that uses it, so that the CUDA cases also
run on a GPU host without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_vote.py``.
"""

import numpy as np
import pytest
import torch

from gdiet_tpu_torch.ops import vote
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def vote_streams(B: int, A: int, seed: int, holes: bool = True):
    """(keys u64, qpos i32, valid bool [B, M], strand i32 [M], vt_distance
    i64, vt_threshold i32, vt_rec_threshold i32 [B]) with M = 2(A+1).
    With ``holes=False`` each half's valid columns come first."""
    rng = np.random.default_rng(seed)
    M = 2 * (A + 1)
    keys = np.full((B, M), U64_MAX, np.uint64)
    qpos = np.zeros((B, M), np.int32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        shared = None
        for s in range(2):
            n = A if b % 5 == 0 else int(rng.integers(0, A + 1))
            nl = int(rng.integers(1, 9))
            loci = ((rng.integers(0, 3, nl).astype(np.uint64) << np.uint64(32))
                    | rng.integers(0, 1 << 20, nl).astype(np.uint64))
            k = np.sort(loci[rng.integers(0, len(loci), n)]
                        + rng.integers(0, 40, n).astype(np.uint64))
            if b % 7 == 3:  # near the top of the u64 range
                k = np.sort(k | np.uint64(0xFFFFFFFF00000000))
            if b % 4 == 2 and n:  # the same run on both sides of the barrier
                if shared is None:
                    shared = k[-1]
                else:
                    k[0] = shared
                    k = np.sort(k)
            off = s * (A + 1)
            keys[b, off:off + n] = k
            qpos[b, off:off + n] = rng.integers(0, 300, n)
            valid[b, off:off + n] = True
            if holes and b % 3 == 1 and n:  # invalid holes inside the stream
                valid[b, off:off + n] &= rng.random(n) >= 0.05
    strand = np.array([0] * (A + 1) + [1] * (A + 1), np.int32)
    dist = rng.integers(0, 60, B).astype(np.int64)
    thr = rng.integers(1, 12, B).astype(np.int32)
    thr[::6] = 10_000  # nothing passes: only the recovery candidate
    rec = rng.integers(0, 6, B).astype(np.int32)
    return keys, qpos, valid, strand, dist, thr, rec


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a).to(device)
            for a in arrays]


def halves(keys, qpos, valid, device="cpu", pad: int = 3) -> list:
    """(fk, fq, fok, rk, rq, rok) of a stream, as column views of [B, A +
    pad] tensors."""
    A = (keys.shape[1] - 2) // 2
    out = []
    for a in (keys, qpos, valid):
        for off in (0, A + 1):
            h = a[:, off:off + A]
            wide = np.concatenate([h, np.zeros((h.shape[0], pad), h.dtype)], 1)
            out += _torch([wide], device)
    return [t[:, :A] for t in (out[0], out[2], out[4], out[1], out[3], out[5])]


@pytest.mark.parametrize("K,seed", [(2, 11), (20, 12)])
def test_plain_matches_jax(K, seed):
    import jax.numpy as jnp

    from gdiet_tpu.pipeline.device_step import _vote_scan

    A = 2048
    arrays = vote_streams(6, A, seed)
    keys, qpos, valid, strand, dist, thr, rec = arrays
    # stretches of columns with no valid hit in any row (the plain loop
    # skips all but the first column of each)
    valid[:, 300:700] = False
    valid[:, A + 1 + 1500:] = False
    ref = _vote_scan(jnp.asarray(keys), jnp.asarray(qpos), jnp.asarray(valid),
                     jnp.asarray(strand), jnp.asarray(dist.astype(np.uint64)),
                     jnp.asarray(thr), jnp.asarray(rec), K=K, A=A)
    calls = vote.vote_calls.n
    h = halves(keys, qpos, valid)
    got = vote.vote_scan(*h, *_torch((dist, thr, rec)), K)  # CPU: the plain loop
    assert vote.vote_calls.n == calls + 1 and vote.launches.n == 0
    plain = vote._vote_scan(*_torch((keys, qpos, valid, strand, dist, thr, rec)), K)
    for name in vote.OUTPUTS:
        want = np.asarray(ref[name])
        have = got[name].numpy()
        if name.endswith("target"):
            have = have.view(np.uint64)
        assert have.dtype == want.dtype and np.array_equal(have, want), name
        assert torch.equal(got[name], plain[name]), name
    out_len, r_score = got["out_len"].numpy(), got["r_score"].numpy()
    assert (out_len == K).any() and ((out_len == 0) & (r_score > 0)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,A,K", [
    (10016, 64, 2),  # the SE bench batch's stream (M = 130)
    (2048, 2048, 2),  # the generic budgets' stream (M = 4,098)
    (2048, 2048, 20),
    (300, 30, 1),
    (64, 30, 310),  # more slots than shared memory holds: slots in the outputs
])
def test_cuda_kernel_matches_plain(B, A, K):
    """The kernel on the halves in place (valid-first, no holes) against
    the plain loop on their concatenation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    keys, qpos, valid, strand, *per_row = vote_streams(B, A, B + K, holes=False)
    per_row = _torch(per_row, "cuda")
    launches = vote.launches.n
    got = vote.vote_scan(*halves(keys, qpos, valid, "cuda"), *per_row, K)
    torch.cuda.synchronize()
    assert vote.launches.n == launches + 1
    ref = vote._vote_scan(*_torch((keys, qpos, valid, strand), "cuda"), *per_row, K)
    for name in vote.OUTPUTS:
        assert torch.equal(got[name], ref[name]), name
