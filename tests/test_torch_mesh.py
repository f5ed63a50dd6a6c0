"""The port's multi-device mapping vs gdiet_tpu's, on virtual CPU meshes.

Meshes of ``"cpu"`` devices run the whole sharded path of
``gdiet_tpu_torch/parallel/dist.py`` on one device, as ``gdiet_tpu``'s own
tests run its mesh on 8 virtual CPU devices (``tests/conftest.py``).
Tolerance: exact everywhere.

- ``ShardedIndex``'s arrays equal ``gdiet_tpu``'s bit for bit at n_ref 1, 2
  and 4; the bisect probe over the shards gives the cuckoo probe's and
  ``DietIndex.lookup``'s counts and the index's occurrence lists for
  present, absent and U64_MAX keys.
- The sharded step's meta and ops equal ``gdiet_tpu.parallel.dist.
  build_sharded_mapper``'s at meshes (4, 2) and (2, 4), and the candidate
  fields equal the port's single-device step's; equal keys of two shards
  keep shard order in the merge.
- ``ShortReadMapper(mesh=...)`` SAM equals ``gdiet_tpu``'s meshed mapper's
  and the port's single-device mapper's at (4, 2), (8, 1) and (2, 2), and
  its regs (``map_batch``) the single-device mapper's at (2, 2);
  the SR CLI with ``--mesh 2x2`` equals ``gdiet_tpu.cli --mesh 2x2``. The
  long-read mesh is tests/test_torch_mesh_lr.py's.
- ``staged_times`` (``-v 4``) returns the four stages, each >= 0, and the
  CLI with ``-v 4`` prints their rows with the golden SAM.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from gdiet_tpu.parallel import dist as jdist
from gdiet_tpu_torch import cli, u64
from gdiet_tpu_torch.config import options_for
from gdiet_tpu_torch.index import TorchIndex
from gdiet_tpu_torch.io.fastx import SeqRecord, read_fastx
from gdiet_tpu_torch.ops import vote
from gdiet_tpu_torch.parallel import dist
from gdiet_tpu_torch.pipeline import device_step as tds
from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper
from gdiet_tpu_torch.testing import sam_body, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


BUDGETS = dict(Lmax=128, S=64, S2=32, A=256)  # tests/test_multichip.py's
SR_ARGS = ["-a", "-t", "1", "-x", "sr", "-Z", "10", "-W", "2", "-k", "21", "-w", "11",
           "-i", "2", "-N", "1", "-r", "0.05,150,200", "-n", "0.95,0.3", "-s", "100",
           "--AF_max_loc", "2", "-v", "1"]


def cpu_mesh(n_data: int, n_ref: int):
    return dist.make_mesh(n_data, n_ref, ["cpu"] * (n_data * n_ref))


def sr_mo():
    """The tiny problem's sr options, built by the port."""
    return options_for("sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
                       bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
                       min_dp_max=100, AF_max_loc=2)[1]


def _with_indels(codes, lens, seed: int = 5):
    """Every third read gets a 1-3 base insertion or deletion mid-read, so
    that the batch needs the DP and the backtrack."""
    rng = np.random.default_rng(seed)
    codes = codes.copy()
    for i in range(0, len(lens), 3):
        L = int(lens[i])
        p, g = int(rng.integers(30, L - 30)), int(rng.integers(1, 4))
        row = codes[i, :L]
        row = (np.concatenate([row[:p], row[p + g:], rng.integers(0, 4, g)]) if i % 2
               else np.concatenate([row[:p], rng.integers(0, 4, g), row[p:L - g]]))
        codes[i, :L] = row.astype(np.uint8)
    return codes


def _reads(codes, lens):
    return [SeqRecord(f"m{i}", "".join("ACGTN"[c] for c in codes[i, :lens[i]]))
            for i in range(len(lens))]


@pytest.fixture(scope="module")
def tiny():
    """tests/test_multichip.py's tiny problem (16 reads of 100 bp on an 8 kb
    genome) with indels added, and the port's index of it."""
    mi, mo, codes, lens, _ = ge._tiny_problem(n_reads=16, lmax=128)
    return mi, mo, TorchIndex.from_numpy(mi, "cpu"), _with_indels(codes, lens), lens


@pytest.fixture(scope="module")
def fixture_index(data_dir):
    from gdiet_tpu.config import options_for as jax_options_for
    from gdiet_tpu.index import build_index

    io_, _ = jax_options_for("sr", pattern="10")
    mi = build_index([(r.name, r.seq) for r in read_fastx(str(data_dir / "ref.fa"))], io_)
    return mi, TorchIndex.from_numpy(mi, "cpu")


@pytest.mark.parametrize("n_ref", [1, 2, 4])
def test_sharded_index_matches_jax(fixture_index, n_ref):
    mi, ti = fixture_index
    want, got = jdist.ShardedIndex(mi, n_ref), dist.ShardedIndex(ti, n_ref)
    for name in ("keys", "starts", "positions", "buckets"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.bucket_shift, got.bucket_iters, got.n_ref) == (
        want.bucket_shift, want.bucket_iters, want.n_ref)


@pytest.mark.parametrize("n_ref", [1, 2, 4])
def test_bisect_probe(fixture_index, n_ref):
    """Present, absent and U64_MAX keys through every shard's bisect probe:
    the summed counts equal the cuckoo probe's and DietIndex.lookup's, the
    owning shard's slice of its positions is the key's occurrence list, and
    the other shards count 0."""
    mi, ti = fixture_index
    rng = np.random.default_rng(n_ref)
    present = rng.choice(mi.keys, 300, replace=False)
    absent = np.setdiff1d(rng.integers(0, 1 << 42, 300, dtype=np.uint64), mi.keys)
    q = np.concatenate([present, mi.keys[:1], mi.keys[-1:], absent,
                        np.full(4, 0xFFFFFFFFFFFFFFFF, np.uint64)])
    n_present = len(present) + 2
    sh = dist.ShardedIndex(ti, n_ref)
    tkv, c1, c2, nb = ti.device_cuckoo_kv()
    cfg = dataclasses.replace(
        tds.StepConfig.from_options(ti, sr_mo(), 1000, 160, 32, 16, 64),
        bucket_shift=sh.bucket_shift, bucket_iters=sh.bucket_iters,
        cuckoo_c1=c1, cuckoo_c2=c2, cuckoo_nb=nb)
    qt = u64.from_numpy(q)
    per_shard = [tds.bisect_lookup(qt, sh.shard(r, "cpu"), cfg) for r in range(n_ref)]
    total = sum(c for _, c in per_shard).numpy()
    np.testing.assert_array_equal(total, tds.cuckoo_lookup(qt, tkv, cfg)[1].numpy())
    np.testing.assert_array_equal(total, np.asarray(mi.lookup(jnp.asarray(q))[1]))
    assert (total[:n_present] > 0).all() and not total[n_present:].any()
    for j, key in enumerate(q[:n_present]):
        owners = [r for r in range(n_ref) if per_shard[r][1][j] > 0]
        assert len(owners) == 1
        s, c = (int(x[j]) for x in per_shard[owners[0]])
        np.testing.assert_array_equal(sh.positions[owners[0], s:s + c], mi.get(int(key)))


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_sharded_step_matches_jax(tiny, mesh_shape):
    """The sharded step's meta (each data row's local opsrow) and ops equal
    gdiet_tpu's build_sharded_mapper step's; the candidate fields of
    tests/test_multichip.py::test_sharded_matches_single equal the port's
    single-device step's."""
    mi, mo, ti, codes, lens = tiny
    n_data, n_ref = mesh_shape
    B = 2 * n_data
    codes, lens = codes[:B], lens[:B]
    _, jstep = jdist.build_sharded_mapper(mi, mo, jdist.make_mesh(n_data, n_ref), **BUDGETS)
    want = jstep(jnp.asarray(codes), jnp.asarray(lens))
    cfg, step = dist.build_sharded_mapper(ti, sr_mo(), cpu_mesh(n_data, n_ref), **BUDGETS)
    assert cfg.probe == "bisect" and cfg.bucket_iters > 0
    got = step(torch.from_numpy(codes), torch.from_numpy(lens))
    np.testing.assert_array_equal(got["meta"].numpy(), np.asarray(want["meta"]))
    np.testing.assert_array_equal(got["ops"].numpy(), np.asarray(want["ops"]))

    single = tds.TorchFusedMapper(ti, sr_mo(), device="cpu", **BUDGETS)
    K = cfg.K
    a = tds.unpack_outputs(got["meta"].numpy(), K)
    b = tds.unpack_outputs(single.fetch(single(codes, lens), B)[0], K)
    for key in ("shift", "extracted", "fallback", "c_valid", "c_score", "c_strand",
                "chrom", "so", "eo", "ts", "te", "dp_score", "exact", "fin_i", "fin_j"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert (a["opsrow"] >= 0).any()  # some rows went through the DP


def test_equal_keys_keep_shard_order(tiny):
    """Two shards give equal diagonal keys for a read's true hits: the merge
    is a stable sort, so they stay in shard order, valid hits first."""
    keys = u64.from_numpy(np.array([[7, 9, 0xFFFFFFFFFFFFFFFF, 7, 8, 9]], np.uint64))
    qpos = torch.tensor([[10, 30, 0, 11, 20, 31]], dtype=torch.int32)
    ok = torch.tensor([[True, True, False, True, True, True]])
    k, q, v = tds.merge_hits(keys, qpos, ok)
    assert u64.to_numpy(k).tolist() == [[7, 7, 8, 9, 9, 0xFFFFFFFFFFFFFFFF]]
    assert q.tolist() == [[10, 11, 20, 30, 31, 0]] and v.tolist() == [[True] * 5 + [False]]

    # in the tiny problem's sharded streams equal keys of two shards occur
    _, _, ti, codes, lens = tiny
    _, step = dist.build_sharded_mapper(ti, sr_mo(), cpu_mesh(1, 2), **BUDGETS)
    halves = step(torch.from_numpy(codes), torch.from_numpy(lens), upto="seed")[0]
    single = tds.TorchFusedMapper(ti, sr_mo(), device="cpu", **BUDGETS)
    ones = single.step(*single.inputs(codes, lens), upto="seed")
    n_equal = 0
    for i in range(len(lens)):
        for sk, sq, sok, k1, q1, ok1 in ((*halves[:3], *ones[:3]), (*halves[3:], *ones[3:])):
            kk, m = u64.to_numpy(sk[i]), sok[i].numpy()
            assert m[:m.sum()].all()  # valid-first
            assert sorted(zip(kk[m], sq[i].numpy()[m])) == sorted(
                zip(u64.to_numpy(k1[i])[ok1[i].numpy()], q1[i].numpy()[ok1[i].numpy()]))
            n_equal += int((np.diff(kk[m].astype(np.int64)) == 0).sum())
    assert n_equal > 0


@pytest.mark.parametrize("mesh_shape", [(4, 2), (8, 1), (2, 2)])
def test_mesh_sam(tiny, mesh_shape):
    """ShortReadMapper(mesh=...) SAM equals gdiet_tpu's meshed mapper's and
    the port's single-device mapper's; the mesh's vote runs over the merged
    stream of A * n_ref columns."""
    from gdiet_tpu.pipeline.shortread import ShortReadMapper as JaxMapper

    mi, mo, ti, codes, lens = tiny
    reads = _reads(codes, lens)
    kw = dict(max_read_len=128, seed_budget=64, shift_seed_budget=32, hit_budget=256)
    jax_mapper = JaxMapper(mi, mo, mesh=jdist.make_mesh(*mesh_shape), **kw)
    want = b"".join(jax_mapper.map_stream_sam(iter([reads])))
    meshed = ShortReadMapper(ti, sr_mo(), mesh=cpu_mesh(*mesh_shape), device="cpu", **kw)
    calls = vote.vote_calls.n
    got = b"".join(bytes(b) for b in meshed.map_stream_sam(iter([reads])))
    assert vote.vote_calls.n > calls
    single = ShortReadMapper(ti, sr_mo(), device="cpu", **kw)
    assert got == want == b"".join(bytes(b) for b in single.map_stream_sam(iter([reads])))
    assert got.count(b"\n") >= len(reads)
    fk = meshed.fused.step(*meshed.fused.inputs(codes, lens), upto="seed")[0][0]
    assert fk.shape[1] == 256 * mesh_shape[1]


def test_mesh_map_batch(tiny):
    """The regs path (map_batch, as the generic writer and the Aligner use
    it) under a (2, 2) mesh equals the single-device mapper's."""
    _, _, ti, codes, lens = tiny
    reads = _reads(codes, lens)[:15]  # padded to 16 rows
    kw = dict(max_read_len=128, seed_budget=64, shift_seed_budget=32, hit_budget=256)
    meshed = ShortReadMapper(ti, sr_mo(), mesh=cpu_mesh(2, 2), **kw)
    single = ShortReadMapper(ti, sr_mo(), device="cpu", **kw)
    got, want = (b"".join(m._regs_to_sam(r, regs, 0) for r, regs in zip(reads, m.map_batch(reads)))
                 for m in (meshed, single))
    assert got == want and got.count(b"\n") >= len(reads)


def test_sr_cli_mesh_matches_jax(data_dir, tmp_path):
    from gdiet_tpu.cli import main as jax_main

    inputs = [str(data_dir / "ref.fa"), str(data_dir / "reads.fq")]
    mine, ref = tmp_path / "port.sam", tmp_path / "jax.sam"
    assert cli.main(["--device", "cpu", *SR_ARGS, "--mesh", "2x2", "-o", str(mine),
                     *inputs]) == 0
    assert jax_main([*SR_ARGS, "--mesh", "2x2", "-o", str(ref), *inputs]) == 0
    assert sam_body(mine) == sam_body(ref) == sam_body(data_dir / "golden.sam")


@pytest.mark.parametrize("meshed", [False, True])
def test_staged_times(tiny, meshed, monkeypatch):
    monkeypatch.setattr(tds, "STAGE_REPS", 1)  # one timed run per cut here
    _, _, ti, codes, lens = tiny
    fused = (dist.ShardedFused(ti, sr_mo(), cpu_mesh(2, 2), **BUDGETS) if meshed
             else tds.TorchFusedMapper(ti, sr_mo(), device="cpu", **BUDGETS))
    launches = vote.launches.n
    st = fused.staged_times(codes, lens)
    assert list(st) == ["pattern", "seed", "vote", "align"]
    assert all(v >= 0.0 for v in st.values()) and sum(st.values()) > 0
    assert vote.launches.n == launches  # CPU tensors: the plain versions


def test_cli_v4_profile(data_dir, tmp_path, capsys, monkeypatch):
    """-v 4 runs the five-stage re-run (the four stages' rows and the
    re-run note are printed; the later rows are marginal differences of
    timings, which can be 0 ns on a batch this small, and print all the
    same) and leaves the SAM unchanged (the first 8 reads of reads.fq)."""
    from gdiet_tpu_torch.utils.profile import PROFILE

    monkeypatch.setattr(tds, "STAGE_REPS", 1)  # one timed run per cut here
    fq = tmp_path / "reads8.fq"
    fq.write_text("\n".join((data_dir / "reads.fq").read_text().splitlines()[:32]) + "\n")
    names = {l[1:].split()[0] for l in fq.read_text().splitlines()[::4]}
    out = tmp_path / "v4.sam"
    PROFILE.reset()
    capsys.readouterr()
    assert cli.main(["--device", "cpu", *SR_ARGS[:-2], "-v", "4", "-o", str(out),
                     str(data_dir / "ref.fa"), str(fq)]) == 0
    err = capsys.readouterr().err
    for stage in ("pattern alignment", "seeding", "voting", "sequence alignment"):
        assert f"[PROFILING] {stage} time: " in err, err[-2000:]
    assert "[PROFILING] note: the per-phase rows are re-run estimates" in err
    golden = [l for l in sam_body(data_dir / "golden.sam") if l.split("\t")[0] in names]
    assert len(golden) >= 8 and sam_body(out) == golden
