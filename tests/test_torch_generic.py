"""The port's generic per-record path vs gdiet_tpu's, on the CPU.

- ``ShortReadMapper.map_batch`` regs written with ``io/sam.sam_record``
  equal the reference binary's golden SAMs (as tests/test_pipeline_parity.py
  holds gdiet_tpu's ``map_batch``).
- ``python -m gdiet_tpu_torch --device cpu`` writes what ``gdiet_tpu.cli``
  writes, byte for byte (SAM bodies, PAF lines, the ``--print-seeds``
  trace), for the options only the per-record writer honours: SR ``--MD``,
  ``--cs``/``--cs=long``, ``-y``, ``-L``, ``-T``, PAF (``-c``,
  ``--paf-no-hit``), ``--print-seeds``; the generic PE writer under
  ``GDIET_NO_PE_FAST=1`` (which also equals the port's fast PE path); LR
  PAF with ``--split-reads``; ``--split-prefix`` with ``-I 40k`` (equal to
  ``golden_split.sam``).
- ``runtime.route`` sends each run where gdiet_tpu/runtime.py:493-514
  sends it, and ``run_mapping`` calls the writer it names.

Tolerance: exact everywhere.
"""

import dataclasses
import io
import pathlib
import sys

import pytest

from gdiet_tpu import debug as jax_debug
from gdiet_tpu.cli import main as jax_main
from gdiet_tpu_torch import config, debug, runtime
from gdiet_tpu_torch.cli import main as port_main
from gdiet_tpu_torch.index import build_index
from gdiet_tpu_torch.io import sam as samio
from gdiet_tpu_torch.io.fastx import read_fastx
from gdiet_tpu_torch.ops import vote
from gdiet_tpu_torch.pipeline import shortread
from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper
from gdiet_tpu_torch.testing import sam_body, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


DATA = pathlib.Path(__file__).parent / "data"
SR = ["-t", "1", "-x", "sr", "-Z", "10", "-W", "2", "-k", "21", "-w", "11",
      "-i", "2", "-N", "1", "-r", "0.05,150,200", "-n", "0.95,0.3", "-s", "100",
      "--AF_max_loc", "2", "-v", "1"]
HIFI = ["-t", "1", "-x", "map-hifi", "-Z", "10", "-W", "2", "-k", "19", "-w", "19",
        "-i", "0.2", "-r", "200", "--vt_dis=650", "--vt_nb_loc=5", "--vt_df1=0.0106",
        "--vt_df2=0.2", "-s", "100", "--vt_cov", "0.04", "--vt_f=0.04", "-v", "1"]


def _lines(path) -> list:
    """SAM body or PAF lines."""
    return sam_body(path)


def _both(tmp_path, args, inputs):
    """(port lines, gdiet_tpu lines) of one argv on ``inputs``."""
    mine, ref = tmp_path / "port.out", tmp_path / "jax.out"
    assert port_main(["--device", "cpu", *args, "-o", str(mine), *inputs]) == 0
    assert jax_main([*args, "-o", str(ref), *inputs]) == 0
    return _lines(mine), _lines(ref)


def _sam(recs, results, mi, mo) -> list:
    out = []
    for rec, regs in zip(recs, results):
        if regs:
            out += [samio.sam_record(rec.name, rec.seq, rec.qual, r, regs, mi.names,
                                     mo.flag, 0)
                    for r in regs
                    if not ((mo.flag & config.MM_F_NO_PRINT_2ND) and r.id != r.parent)]
        else:
            out.append(samio.sam_record(rec.name, rec.seq, rec.qual, None, [],
                                        mi.names, mo.flag, 0))
    return out


@pytest.mark.parametrize("ref,reads,golden,lmax", [
    ("ref.fa", "reads.fq", "golden.sam", 256),
    ("ref2.fa", "reads2.fq", "golden2_10.sam", 512),
])
def test_map_batch_golden(ref, reads, golden, lmax):
    io_, mo = config.options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05, bw_min=150,
        bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3, min_dp_max=100, AF_max_loc=2)
    mi = build_index([(r.name, r.seq) for r in read_fastx(str(DATA / ref))], io_, "cpu")
    mapper = ShortReadMapper(mi, mo, max_read_len=lmax, device="cpu")
    recs = list(read_fastx(str(DATA / reads)))
    calls = vote.vote_calls.n
    assert _sam(recs, mapper.map_batch(recs), mi, mo) == sam_body(DATA / golden)
    # on CPU tensors the vote runs the plain loop, never the kernel
    assert vote.vote_calls.n > calls and vote.launches.n == 0


def test_map_stream_sub_batches(monkeypatch):
    """map_stream over batches of 20, 0 and 30 reads in device sub-batches
    of 16 reads writes golden.sam; the sub-batch size follows the budgets."""
    io_, mo = config.options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05, bw_min=150,
        bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3, min_dp_max=100, AF_max_loc=2)
    mi = build_index([(r.name, r.seq) for r in read_fastx(str(DATA / "ref.fa"))], io_, "cpu")
    cfg = ShortReadMapper(mi, mo, device="cpu").fused.cfg
    assert shortread.sub_batch_reads(cfg) == 65536  # K = 2: the stream and dirs fit
    wide = dataclasses.replace(cfg, K=20)
    assert 8192 < shortread.sub_batch_reads(wide) < 32768  # K = 20: 10 DP rows per read
    monkeypatch.setattr(shortread, "sub_batch_reads", lambda cfg: 16)
    mapper = ShortReadMapper(mi, mo, device="cpu")
    recs = list(read_fastx(str(DATA / "reads.fq")))
    calls = vote.vote_calls.n
    out = list(mapper.map_stream(iter([recs[:20], [], recs[20:]])))
    assert [len(b) for b in out] == [20, 0, 30]
    assert vote.vote_calls.n - calls == 4  # 16 + 4, none, 16 + 14
    assert _sam(recs, [r for b in out for r in b], mi, mo) == sam_body(DATA / "golden.sam")


@pytest.fixture
def commented_reads(tmp_path):
    """reads.fq with a FASTQ comment on every other record (for -y) and a
    40 bp dinucleotide repeat in every fifth read (which SDUST masks at
    -T 20, so those reads take the host path)."""
    lines = (DATA / "reads.fq").read_text().splitlines()
    for i in range(0, len(lines), 8):
        lines[i] += f"\tBC:Z:{'ACGT'[i // 8 % 4] * 8}"
    for i in range(1, len(lines), 20):
        lines[i] = lines[i][:50] + "CA" * 20 + lines[i][90:]
    path = tmp_path / "reads_comments.fq"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("opts", [
    ["-a", "--MD", "--cs", "-y"],
    ["-a", "--cs=long", "-L", "-T", "20"],
    ["-c", "--paf-no-hit", "--cs"],
], ids=["md_cs_y", "cslong_L_T", "paf_cg_cs_nohit"])
def test_sr_generic_cli_matches_jax(tmp_path, commented_reads, opts):
    mine, ref = _both(tmp_path, [*opts, *SR], [str(DATA / "ref.fa"), str(commented_reads)])
    assert len(ref) >= 40 and mine == ref


def test_print_seeds_matches_jax(tmp_path):
    """--print-seeds: every read maps through the tracing oracle on one
    thread; the SAM and the stderr trace equal gdiet_tpu's."""
    traces = []
    for mod, run in ((debug, lambda: port_main(["--device", "cpu", *args])),
                     (jax_debug, lambda: jax_main(args))):
        buf = io.StringIO()
        out = tmp_path / f"{len(traces)}.sam"
        args = ["-a", "--print-seeds", *SR, "-o", str(out), str(DATA / "ref.fa"),
                str(DATA / "reads.fq")]
        mod.set_print_seed(False, out=buf)
        try:
            assert run() == 0
        finally:
            mod.set_print_seed(False, out=sys.stderr)
        traces.append((sam_body(out), buf.getvalue()))
    (mine, mine_tr), (ref, ref_tr) = traces
    assert mine == ref and mine == sam_body(DATA / "golden.sam")
    assert "VT n: " in ref_tr and mine_tr == ref_tr


@pytest.fixture
def pe_subset(tmp_path):
    """The first 64 pairs of the PE fixture."""
    paths = []
    for name in ("reads_pe_1.fq", "reads_pe_2.fq"):
        p = tmp_path / name
        p.write_text("\n".join((DATA / name).read_text().splitlines()[:4 * 64]) + "\n")
        paths.append(str(p))
    return paths


def test_generic_pe_matches_jax_and_fast_pe(tmp_path, pe_subset, monkeypatch):
    inputs = [str(DATA / "ref_pe.fa"), *pe_subset]
    monkeypatch.setenv("GDIET_NO_PE_FAST", "1")
    mine, ref = _both(tmp_path, ["-a", *SR], inputs)
    assert len(ref) >= 128 and mine == ref
    monkeypatch.delenv("GDIET_NO_PE_FAST")
    fast = tmp_path / "fast.sam"
    assert port_main(["--device", "cpu", "-a", *SR, "-o", str(fast), *inputs]) == 0
    assert sam_body(fast) == mine


def test_lr_paf_split_reads_matches_jax(tmp_path):
    """The first 8 HiFi fixture reads, cut into 700 bp chunks, to PAF with
    cs tags (LR through the banded plain DP on the CPU)."""
    sub = tmp_path / "reads_lr8.fq"
    sub.write_text("\n".join((DATA / "reads_lr.fq").read_text().splitlines()[:32]) + "\n")
    mine, ref = _both(tmp_path, ["-c", "--cs", "--split-reads", "700", *HIFI],
                      [str(DATA / "ref_lr.fa"), str(sub)])
    assert len(ref) >= 12 and mine == ref


def test_split_prefix_golden(tmp_path):
    out = tmp_path / "split.sam"
    assert port_main(["--device", "cpu", "-a", *SR, "-I", "40k", "--split-prefix",
                      str(tmp_path / "sp"), "-o", str(out), str(DATA / "ref2.fa"),
                      str(DATA / "reads2.fq")]) == 0
    assert sam_body(out) == sam_body(DATA / "golden_split.sam")


def _mo(*flags, **fields):
    _, mo = config.options_for("sr")
    for f in flags:
        mo.flag |= f
    for k, v in fields.items():
        setattr(mo, k, v)
    return mo


SAM, CIGAR = config.MM_F_OUT_SAM, config.MM_F_CIGAR


@pytest.mark.parametrize("mo,variant,n_q,env,max_len,path", [
    (_mo(SAM, CIGAR), "sr", 1, {}, None, "sr_se"),
    (_mo(SAM, CIGAR), "sr", 2, {}, None, "sr_pe"),
    (_mo(SAM, CIGAR), "sr", 2, {"GDIET_NO_PE_FAST": "1"}, None, "generic"),
    (_mo(SAM, CIGAR, pe_ori=-1), "sr", 2, {}, None, "generic"),
    (_mo(SAM), "sr", 2, {}, None, "generic"),  # no CIGAR
    (_mo(SAM), "sr", 1, {}, None, "sr_se"),  # SE needs no CIGAR
    (_mo(SAM, CIGAR), "sr", 3, {}, None, "generic"),
    (_mo(CIGAR), "sr", 1, {}, None, "generic"),  # PAF
    (_mo(SAM, CIGAR, config.MM_F_OUT_CG), "sr", 1, {}, None, "generic"),
    (_mo(SAM, CIGAR, config.MM_F_OUT_MD), "sr", 2, {}, None, "generic"),
    (_mo(SAM, CIGAR, config.MM_F_OUT_CS), "sr", 1, {}, None, "generic"),
    (_mo(SAM, CIGAR, config.MM_F_OUT_CS_LONG), "sr", 1, {}, None, "generic"),
    (_mo(SAM, CIGAR, config.MM_F_COPY_COMMENT), "sr", 1, {}, None, "generic"),
    (_mo(SAM, CIGAR, config.MM_F_LONG_CIGAR), "sr", 1, {}, None, "sr_se"),
    (_mo(SAM, CIGAR, sdust_thres=20), "sr", 1, {}, None, "generic"),
    (_mo(SAM, CIGAR, sdust_thres=20), "sr", 2, {}, None, "generic"),
    (_mo(SAM, CIGAR, split_len=1000), "sr", 1, {}, None, "generic"),
    (_mo(SAM, CIGAR), "sr", 1, {}, 512, "generic"),
    (_mo(SAM, CIGAR), "lr", 1, {}, None, "generic"),
    (_mo(SAM, CIGAR), "lr", 2, {}, None, "generic"),
    (_mo(SAM, CIGAR), "sr", 1, {"print_seeds": "1"}, None, "generic"),
    (_mo(SAM, CIGAR), "sr", 2, {"print_seeds": "1"}, None, "generic"),
])
def test_route(monkeypatch, mo, variant, n_q, env, max_len, path):
    """The writer of each routing condition (gdiet_tpu/runtime.py:493-514)."""
    monkeypatch.delenv("GDIET_NO_PE_FAST", raising=False)
    for k, v in env.items():
        if k == "print_seeds":
            monkeypatch.setattr(debug, "PRINT_SEED", True)
        else:
            monkeypatch.setenv(k, v)
    assert runtime.route(mo, variant, ["q.fq"] * n_q, max_len) == path


def test_run_mapping_calls_the_routed_writer(monkeypatch, pe_subset):
    """run_mapping hands each run to the writer route() names."""
    seen = []
    for name in ("run_sr_sam", "run_sr_pe_sam", "run_generic"):
        monkeypatch.setattr(runtime, name, lambda *a, _n=name, **k: seen.append(_n) or 0)
    ref = str(DATA / "ref_pe.fa")
    for opts, queries in ((["-a"], pe_subset[:1]), (["-a"], pe_subset),
                          (["-a", "--MD"], pe_subset), (["-c"], pe_subset[:1])):
        assert port_main(["--device", "cpu", *opts, *SR, ref, *queries]) == 0
    assert seen == ["run_sr_sam", "run_sr_pe_sam", "run_generic", "run_generic"]


def test_mesh_raises(monkeypatch):
    """A --mesh of cards needs DATA x REF visible CUDA devices: without
    them it raises, and drops neither to the CPU nor to one card (the
    mapping itself is tests/test_torch_mesh.py's)."""
    import torch

    from gdiet_tpu_torch.parallel.dist import device_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 CUDA devices"):
        device_mesh((2, 2), "cuda")
