"""Port fused step vs gdiet_tpu's fused_map_step, bit for bit, on the CPU.

The same numpy batch goes through the JAX step (plain XLA DP, as on any
non-TPU backend) and the port's step; the sorted hit streams (``upto=
"seed"``), the vote state (``upto="vote"``) and the packed meta/ops must be
identical.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_problem
from gdiet_tpu.config import options_for
from gdiet_tpu.index import build_index
from gdiet_tpu.io.fastx import read_fastx
from gdiet_tpu.oracle.sketch import seq_to_code
from gdiet_tpu.pipeline.device_step import FusedMapper, fused_map_step
from gdiet_tpu_torch import u64
from gdiet_tpu_torch.index import TorchIndex
from gdiet_tpu_torch.pipeline import device_step as tds
from gdiet_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _fixture_problem(data_dir):
    io_, mo = options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2,
    )
    mi = build_index([(r.name, r.seq) for r in read_fastx(str(data_dir / "ref.fa"))], io_)
    reads = list(read_fastx(str(data_dir / "reads.fq")))
    lmax = 160
    codes = np.full((len(reads), lmax), 255, np.uint8)
    lens = np.zeros(len(reads), np.int64)
    for i, r in enumerate(reads):
        c = seq_to_code(r.seq)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    # an N base and a reverse-complemented copy exercise the N paths
    codes[3, 40] = 4
    codes[7] = np.where(codes[7] < 4, 3 - codes[7], codes[7])
    codes[7, :150] = codes[7, :150][::-1]
    return mi, mo, codes, lens, lmax


def _repeat_problem():
    """A genome with a 171-bp tandem array, a dispersed 800-bp repeat, a
    6-bp short tandem repeat and N bases, mapped with mid_occ 6: seeds go
    high-occurrence (mm_seed_select's streak path), reads in the short
    tandem repeat carry duplicate minimizers (the q-occ check) and windows
    cross N bases (the reference N mask)."""
    rng = np.random.default_rng(17)
    g = rng.integers(0, 4, 60_000)
    g[20_000:30_000] = np.tile(rng.integers(0, 4, 171), 59)[:10_000]
    rep = rng.integers(0, 4, 800)
    for i in range(10):
        g[32_000 + 2_500 * i: 32_800 + 2_500 * i] = rep
    g[5_000:6_200] = np.tile(rng.integers(0, 4, 6), 200)
    seq = np.array(list("ACGT"))[g]
    seq[[5_310, 21_000, 21_007, 40_123]] = "N"
    seq = "".join(seq)
    io_, mo = options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2,
    )
    mo.mid_occ, mo.max_max_occ, mo.occ_dist = 6, 400, 100
    mi = build_index([("chr1", seq)], io_)
    lmax, spans = 160, [(19_900, 30_100), (31_900, 57_000), (4_950, 6_250)]
    n = 50  # the fixture's batch shape: the JAX side reuses its compiles
    codes = np.full((n, lmax), 255, np.uint8)
    lens = np.full(n, 150, np.int64)
    for i in range(n):
        lo, hi = spans[i % 3]
        st = int(rng.integers(lo, hi - 150))
        c = seq_to_code(seq[st: st + 150])
        c[rng.integers(0, 150, 2)] = rng.integers(0, 4, 2)
        if i % 2:
            c = np.where(c < 4, 3 - c, c)[::-1]
        codes[i, :150] = c
    return mi, mo, codes, lens, lmax


def _add_indels(codes, lens, seed):
    """Give every third read a 1-3 base deletion or insertion mid-read so
    that the batch needs the DP and the backtrack."""
    rng = np.random.default_rng(seed)
    for i in range(0, len(lens), 3):
        L = int(lens[i])
        p, g = int(rng.integers(30, L - 30)), int(rng.integers(1, 4))
        row = codes[i, :L].copy()
        if i % 2:
            row = np.concatenate([row[:p], row[p + g:], rng.integers(0, 4, g)])
        else:
            row = np.concatenate([row[:p], rng.integers(0, 4, g), row[p:L - g]])
        codes[i, :L] = row.astype(np.uint8)
    return codes


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return u64.to_numpy(x) if x.dtype == torch.int64 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint64) if a.dtype == np.int64 else a


def _same(name, ref, got):
    ref, got = np.asarray(ref), _as_np(got)
    if ref.dtype == np.uint64 or got.dtype == np.uint64:
        ref, got = ref.astype(np.uint64), got.astype(np.uint64)
    np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=name)


@pytest.mark.parametrize("problem,budgets", [
    ("tiny", dict(Lmax=128, S=64, S2=32, A=256, dp_frac=1.0)),
    ("fixture", dict(Lmax=160, S=32, S2=16, A=64, dp_frac=0.3125)),
    ("repeats", dict(Lmax=160, S=32, S2=16, A=64, dp_frac=0.3125)),
])
def test_step_bit_equal(data_dir, problem, budgets):
    if problem == "tiny":
        mi, mo, codes, lens, _ = _tiny_problem(n_reads=24, lmax=budgets["Lmax"])
    elif problem == "fixture":
        mi, mo, codes, lens, _ = _fixture_problem(data_dir)
    else:
        mi, mo, codes, lens, _ = _repeat_problem()
    codes = _add_indels(codes, lens, seed=len(lens))
    jm = FusedMapper(mi, mo, **budgets)
    tm = tds.TorchFusedMapper(TorchIndex.from_numpy(mi, "cpu"), mo,
                              **budgets, device="cpu")
    jc, jl = jnp.asarray(codes), jnp.asarray(lens)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens)

    def run_j(upto):
        return fused_map_step(jc, jl, **jm.arrays, cfg=jm.cfg, upto=upto)

    def run_t(upto):
        return tds.fused_map_step(tc, tl, tm.tables, tm.cfg, upto=upto)

    names = ("fk", "fq", "fok", "rk", "rq", "rok")
    for n, a, b in zip(names, run_j("seed"), run_t("seed")):
        _same(f"seed/{n}", a, b)
    vj, vt = run_j("vote"), run_t("vote")
    assert sorted(vj) == sorted(vt)
    for n in vj:
        _same(f"vote/{n}", vj[n], vt[n])
    oj, ot = run_j(None), run_t(None)
    meta = np.asarray(oj["meta"])
    _same("meta", meta, ot["meta"])
    _same("ops", oj["ops"], ot["ops"])
    # the batch must reach the DP, not only the exact/sub-only shortcuts
    K = jm.cfg.K
    assert (meta[:, 3 + 11 * K: 3 + 12 * K] >= 0).any()


FIXTURE_BUDGETS = dict(Lmax=160, S=32, S2=16, A=64, dp_frac=0.3125)


@pytest.mark.parametrize("problem", ["fixture", "repeats"])
def test_step_fold_bit_equal(data_dir, monkeypatch, problem):
    """The folded DP on the DP rows the port's step hands to
    ``extd2_batch``: the fold is SAM-identical (dp_pallas.py:57-58), so its
    scores and its backtrack equal the step's full width on every live
    row, and the step itself, which never folds, writes JAX's meta and
    ops."""
    from gdiet_tpu_torch.ops import dp_fold, extd2

    mi, mo, codes, lens, _ = (_fixture_problem(data_dir) if problem == "fixture"
                              else _repeat_problem())
    codes = _add_indels(codes, lens, seed=len(lens))
    jm = FusedMapper(mi, mo, **FIXTURE_BUDGETS)
    tm = tds.TorchFusedMapper(TorchIndex.from_numpy(mi, "cpu"), mo,
                              **FIXTURE_BUDGETS, device="cpu")
    dp_batch, seen = extd2.extd2_batch, []
    monkeypatch.setattr(extd2, "extd2_batch",
                        lambda *a, **kw: seen.append((a, kw)) or dp_batch(*a, **kw))
    oj = fused_map_step(jnp.asarray(codes), jnp.asarray(lens), **jm.arrays, cfg=jm.cfg)
    calls = dp_fold.calls.n
    ot = tds.fused_map_step(torch.from_numpy(codes), torch.from_numpy(lens),
                            tm.tables, tm.cfg)
    assert dp_fold.calls.n == calls and len(seen) == 1
    meta = np.asarray(oj["meta"])
    _same("meta", meta, ot["meta"])
    _same("ops", oj["ops"], ot["ops"])
    K = jm.cfg.K
    assert (meta[:, 3 + 11 * K: 3 + 12 * K] >= 0).any()

    (q, t, ln, bd, params, L), kw = seen[0]
    full = dp_batch(q, t, ln, bd, params, L, **kw)
    fold = dp_batch(q, t, ln, bd, params, L, fold=True,
                    state_dtype=extd2.route_state_dtype(params, L, fold=True))
    assert dp_fold.calls.n == calls + 1
    live = (ln > 0).numpy()
    assert live.sum() > 0
    _same("score", full[0].numpy()[live], fold[0][live])
    bt_full = extd2.backtrack_band(full[1], ln, ln, bd, L, L)
    bt_fold = extd2.backtrack_band(fold[1], ln, ln, bd, L, L, fold=True)
    for name, a, b in zip(("ops", "fin_i", "fin_j"), bt_full, bt_fold):
        _same(name, a.numpy()[live], b[live])


def test_mapper_resolves_fold():
    """No mapper folds the DP: the single-end mapper, its retry tier and
    the paired-end path all run the full width (the fold is a
    kernel-level layout of ``extd2_batch``)."""
    from gdiet_tpu_torch.io.fastx import SeqRecord
    from gdiet_tpu_torch.ops import dp, dp_fold
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    mi, mo, codes, lens, _ = _tiny_problem(n_reads=4, lmax=128)
    tmi = TorchIndex.from_numpy(mi, "cpu")
    sm = ShortReadMapper(tmi, mo, max_read_len=160, seed_budget=32,
                         shift_seed_budget=16, hit_budget=64, dp_frac=0.3125,
                         device="cpu")
    assert not hasattr(sm.fused.cfg, "dp_fold")
    seqs = ["".join("ACGTN"[c] for c in row[:n]) for row, n in zip(codes, lens)]
    reads = [SeqRecord(f"r{i}", s, "I" * len(s)) for i, s in enumerate(seqs)]
    calls, fold_calls = dp.calls.n, dp_fold.calls.n
    sm.map_batch(reads)
    sm._retry_batch_regs(reads)
    b"".join(bytes(b) for b in sm.map_stream_sam_pe(iter([list(zip(reads[::2],
                                                                   reads[1::2]))])))
    assert dp.calls.n >= calls + 3 and dp_fold.calls.n == fold_calls


@pytest.mark.parametrize("problem", ["tiny", "fixture"])
def test_step_frac_seeds_bit_equal(data_dir, problem):
    """The fractional -i branch (the sr preset's default -i 0.1): cropped
    shift-0 inference, then the query sketch, at every cut of the step."""
    if problem == "tiny":
        budgets = dict(Lmax=128, S=64, S2=32, A=256, dp_frac=1.0)
        mi, mo, codes, lens, _ = _tiny_problem(n_reads=24, lmax=128)
    else:
        budgets = FIXTURE_BUDGETS
        mi, mo, codes, lens, _ = _fixture_problem(data_dir)
    mo.max_seeds = 0.1
    codes = _add_indels(codes, lens, seed=len(lens))
    jm = FusedMapper(mi, mo, **budgets)
    tm = tds.TorchFusedMapper(TorchIndex.from_numpy(mi, "cpu"), mo,
                              **budgets, device="cpu")
    assert jm.cfg.frac_mode and tm.cfg.frac_mode
    jc, jl = jnp.asarray(codes), jnp.asarray(lens)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens)
    names = ("fk", "fq", "fok", "rk", "rq", "rok")
    seed_j = fused_map_step(jc, jl, **jm.arrays, cfg=jm.cfg, upto="seed")
    for n, a, b in zip(names, seed_j, tds.fused_map_step(tc, tl, tm.tables, tm.cfg,
                                                         upto="seed")):
        _same(f"seed/{n}", a, b)
    vj = fused_map_step(jc, jl, **jm.arrays, cfg=jm.cfg, upto="vote")
    vt = tds.fused_map_step(tc, tl, tm.tables, tm.cfg, upto="vote")
    for n in vj:
        _same(f"vote/{n}", vj[n], vt[n])
    oj = fused_map_step(jc, jl, **jm.arrays, cfg=jm.cfg)
    ot = tds.fused_map_step(tc, tl, tm.tables, tm.cfg)
    _same("meta", np.asarray(oj["meta"]), ot["meta"])
    _same("ops", oj["ops"], ot["ops"])
    assert np.asarray(seed_j[2]).any()  # hits reach the vote


def test_seed_select_streaks():
    """mm_seed_select on seeded counts where most seeds are high-occurrence
    (the step's fixtures rarely exceed mid_occ)."""
    from gdiet_tpu.pipeline.device_step import _seed_select_device

    rng = np.random.default_rng(3)
    B, S = 64, 32
    cnts = rng.choice([0, 1, 3, 9, 40, 700, 5000], (B, S)).astype(np.int64)
    qpos = np.sort(rng.integers(0, 150, (B, S)), axis=1).astype(np.int32)
    n_ok = rng.integers(0, S + 1, B)
    seed_ok = np.arange(S)[None, :] < n_ok[:, None]
    lens = np.full(B, 150, np.int64)
    cfg = tds.StepConfig(
        k=21, w=11, pattern="10", Lmax=160, S=S, S2=16, A=64, K=2,
        max_nb_seeds=800, frac_mode=False, max_seeds=2.0, min_cnt=0.95,
        rec_frac=0.3, bw_min=150, bw_max=200, bw_frac=0.05, occ_dist=30,
        max_max_occ=1000, q_occ_on=True, q_occ_frac=0.01, mid_occ=6,
        match_a=2, params=(2, 8, 12, 2, 24, 1), frag_mode=True)
    ref = _seed_select_device(jnp.asarray(cnts), jnp.asarray(qpos),
                              jnp.asarray(seed_ok), jnp.asarray(lens), cfg)
    got = tds._seed_select(torch.from_numpy(cnts), torch.from_numpy(qpos),
                           torch.from_numpy(seed_ok), torch.from_numpy(lens), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    present = seed_ok & (cnts > 0)
    assert (present & ~np.asarray(ref) & (cnts <= 1000)).any()  # some dropped


def test_window_rows_packed_with_n_mask():
    from gdiet_tpu.pipeline.device_step import _window_rows_packed, pack_ref_codes

    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 5_003).astype(np.uint8)
    ref[rng.integers(0, 5_003, 60)] = 4
    packed, nmask = pack_ref_codes(ref)
    L = 160
    fstart = rng.integers(0, len(ref) - L, 200).astype(np.int64)
    want = np.asarray(_window_rows_packed(jnp.asarray(packed), jnp.asarray(fstart),
                                          L, nmask=jnp.asarray(nmask)))
    got = tds.window_rows_packed(torch.from_numpy(packed), torch.from_numpy(nmask),
                                 torch.from_numpy(fstart), L)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, ref[fstart[:, None] + np.arange(L)])
