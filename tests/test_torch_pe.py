"""Port paired-end CLI vs gdiet_tpu's, byte for byte, on the CPU.

``python -m gdiet_tpu_torch --device cpu`` on the PE fixture (the ARGS of
``tests/test_pe_fast.py``) must write the SAM body that ``gdiet_tpu.cli``
writes, with one and with three threads (the full-width DP: the port's
PE path never folds), with the preset's fractional ``-i``, and across
several batches with a padded tail and trailing records without a mate.
"""

import functools
import pathlib

import pytest

from gdiet_tpu import native
from gdiet_tpu.cli import main as jax_main
from gdiet_tpu_torch import runtime
from gdiet_tpu_torch.cli import main as port_main
from gdiet_tpu_torch.ops import dp, dp_fold
from gdiet_tpu_torch.testing import sam_body as _body, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


DATA = pathlib.Path(__file__).parent / "data"
ARGS = ["-a", "-t", "1", "-x", "sr", "-Z", "10", "-W", "2", "-k", "21",
        "-w", "11", "-i", "2", "-N", "1", "-r", "0.05,150,200",
        "-n", "0.95,0.3", "-s", "100", "--AF_max_loc", "2", "-v", "1"]
FRAC_ARGS = ARGS[:ARGS.index("-i")] + ARGS[ARGS.index("-i") + 2:]
INPUTS = [str(DATA / "ref_pe.fa"), str(DATA / "reads_pe_1.fq"),
          str(DATA / "reads_pe_2.fq")]

pytestmark = pytest.mark.skipif(native.lib is None, reason="needs the native library")


@pytest.fixture(scope="module")
def jax_sam(tmp_path_factory):
    """The JAX CLI's SAM body per argument set, each run once."""
    cache = {}

    def run(args, inputs=tuple(INPUTS)):
        key = (tuple(args), tuple(inputs))
        if key not in cache:
            out = tmp_path_factory.mktemp("jax") / "jax.sam"
            assert jax_main([*args, "-o", str(out), *inputs]) == 0
            cache[key] = _body(out)
        return cache[key]
    return run


def _batch_pairs(monkeypatch, n: int):
    """Both runtimes' PE entry points with n pairs per batch."""
    from gdiet_tpu import runtime as jax_runtime

    monkeypatch.setattr(jax_runtime, "_run_sr_pe_sam_fast", functools.partial(
        jax_runtime._run_sr_pe_sam_fast, batch_pairs=n))
    monkeypatch.setattr(runtime, "run_sr_pe_sam",
                        functools.partial(runtime.run_sr_pe_sam, batch_pairs=n))


def _port(tmp_path, args, inputs=INPUTS):
    out = tmp_path / "port.sam"
    assert port_main(["--device", "cpu", *args, "-o", str(out), *inputs]) == 0
    return _body(out)


@pytest.mark.parametrize("threads", ["1", "3"])
def test_pe_cli_matches_jax(jax_sam, tmp_path, threads):
    """The port on one or three threads writes what JAX writes on one."""
    args = [*ARGS[:ARGS.index("-t") + 1], threads, *ARGS[ARGS.index("-t") + 2:]]
    calls, fold_calls = dp.calls.n, dp_fold.calls.n
    mine = _port(tmp_path, args)
    assert dp.calls.n > calls and dp_fold.calls.n == fold_calls
    ref = jax_sam(ARGS)
    assert len(ref) >= 600 and mine == ref


def test_pe_cli_frac_seeds_matches_jax(jax_sam, tmp_path):
    """Without -i 2 the sr preset's -i 0.1 takes the fractional branch."""
    assert _port(tmp_path, FRAC_ARGS) == jax_sam(FRAC_ARGS)


def test_pe_batches_and_unpaired_tail(tmp_path, monkeypatch):
    """Batches of 64 pairs (the last one padded) and an R2 file 37 records
    shorter than R1. Both runtimes stop pairing at the first R1 record
    without a mate and map it single-end at the end."""
    _batch_pairs(monkeypatch, 64)
    lines = (DATA / "reads_pe_2.fq").read_text().splitlines(keepends=True)
    n_pairs = len(lines) // 4 - 37
    short = tmp_path / "r2_short.fq"
    short.write_text("".join(lines[:4 * n_pairs]))
    inputs = INPUTS[:2] + [str(short)]
    mine = _port(tmp_path, ARGS, inputs)
    assert jax_main([*ARGS, "-o", str(tmp_path / "jax.sam"), *inputs]) == 0
    assert mine == _body(tmp_path / "jax.sam")
    assert not int(mine[-1].split("\t")[1]) & 1  # a single-end record


def test_pe_oracle_matches_native(tmp_path):
    """The per-pair oracle finish (the fallback of pairs outside the
    envelope) writes what the native pe_finish_batch writes, under the
    flags of -a (CIGAR output, which mm_pair needs)."""
    from gdiet_tpu_torch import config
    from gdiet_tpu_torch.index import build_index
    from gdiet_tpu_torch.io.fastx import read_fastx as read
    from gdiet_tpu_torch.pipeline.shortread import ShortReadMapper

    io_, mo = config.options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2)
    mo.flag |= config.MM_F_OUT_SAM | config.MM_F_CIGAR
    mi = build_index([(r.name, r.seq) for r in read(INPUTS[0])], io_, "cpu")
    mapper = ShortReadMapper(mi, mo, max_read_len=160, seed_budget=32,
                             shift_seed_budget=16, hit_budget=64,
                             dp_frac=0.3125, device="cpu")
    pairs = list(zip(read(INPUTS[1]), read(INPUTS[2])))[:24]
    blob = b"".join(bytes(b) for b in mapper.map_stream_sam_pe(iter([pairs])))
    assert mapper.stats["fallback_reads"] == 0
    assert blob == b"".join(mapper._oracle_sam_pe(p, 0) for p in pairs)
