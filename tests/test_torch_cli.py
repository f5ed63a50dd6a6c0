"""The port's CLI parses every option of ``gdiet_tpu/cli.py`` as it does.

Each argv goes through both ``main``s with their ``runtime.run_mapping``
replaced by a recorder: the ``IndexOptions``/``MapOptions`` fields
(``dataclasses.asdict``), the variant, the files, the thread count, the
verbosity and the command line handed over must be equal, and so must the
``--print-seeds`` switch. Options without effect warn on both sides and go
on; ``-h`` and ``-V`` return 0 on both. Tolerance: exact.
"""

import dataclasses

import pytest

from gdiet_tpu import cli as jax_cli
from gdiet_tpu import debug as jax_debug
from gdiet_tpu import runtime as jax_runtime
from gdiet_tpu_torch import cli, debug, runtime

FILES = ["ref.fa", "reads.fq"]
SR = ["-x", "sr"]
CASES = {
    "w": [*SR, "-w", "7"], "k": [*SR, "-k", "17"], "Z_W": [*SR, "-Z", "110", "-W", "3"],
    "i": [*SR, "-i", "0.3"], "i_neg": [*SR, "-i", "-1"], "H": [*SR, "-H"],
    "d": [*SR, "-d", "idx.npz"], "t": [*SR, "-t", "7"], "v": [*SR, "-v", "1"],
    "g": ["-x", "map-ont", "-g", "5k"], "F": [*SR, "-F", "1k,3"], "N": [*SR, "-N", "4"],
    "p": [*SR, "-p", "0.7"], "M": [*SR, "-M", "0.6"], "c": [*SR, "-c"], "a": [*SR, "-a"],
    "Q": [*SR, "-Q"], "Y": [*SR, "-Y"], "L": [*SR, "-L"], "y": [*SR, "-y"],
    "T": [*SR, "-T", "20"], "n": [*SR, "-n", "0.9,0.2"], "m": [*SR, "-m", "30"],
    "A_B": [*SR, "-A", "3", "-B", "5"], "s": [*SR, "-s", "80"], "I": [*SR, "-I", "40k"],
    "K": [*SR, "-K", "100M"], "e": [*SR, "-e", "300"], "2": [*SR, "-2"],
    "o": [*SR, "-o", "out.sam"], "r_sr": [*SR, "-r", "0.1,100,300"],
    "r_sr_int": [*SR, "-r", "500"], "r_lr": ["-x", "map-hifi", "-r", "1300"],
    "U": [*SR, "-U", "10,500"], "f_frac": [*SR, "-f", "0.001,5000"],
    "f_int": [*SR, "-f", "300"], "z": [*SR, "-z", "200,100"],
    "O_E": [*SR, "-O", "5,30", "-E", "3,2"], "G": [*SR, "-G", "200k"],
    "bundled": [*SR, "-aQt4"],
    "bucket_bits": [*SR, "--bucket-bits", "12"], "seed": [*SR, "--seed", "7"],
    "min_occ_floor": [*SR, "--min-occ-floor", "20"],
    "q_occ_frac": [*SR, "--q-occ-frac", "0.02"], "max_qlen": [*SR, "--max-qlen", "10k"],
    "idx_no_seq": [*SR, "--idx-no-seq"], "eqx": [*SR, "--eqx"], "MD": [*SR, "--MD"],
    "cs": [*SR, "--cs"], "cs_long": [*SR, "--cs=long"], "cs_none": [*SR, "--cs=none"],
    "cs_long_short": [*SR, "--cs=long", "--cs=short"],
    "paf_no_hit": [*SR, "--paf-no-hit"], "for_only": [*SR, "--for-only"],
    "rev_only": [*SR, "--rev-only"], "split_prefix": [*SR, "--split-prefix", "pre"],
    "AF_dis": [*SR, "--AF_dis", "0.5"], "AF_max_loc": [*SR, "--AF_max_loc", "5"],
    "vt_dis": ["-x", "map-hifi", "--vt_dis=650"], "vt_nb_loc": ["-x", "map-hifi", "--vt_nb_loc", "5"],
    "vt_cov": ["-x", "map-hifi", "--vt_cov", "0.04"], "vt_df1": ["-x", "map-ont", "--vt_df1=0.01"],
    "vt_df2": ["-x", "map-ont", "--vt_df2", "0.2"], "vt_f": ["-x", "map-hifi", "--vt_f=0.04"],
    "max_max_gap": ["-x", "map-ont", "--max_max_gap", "5000"],
    "max_min_gap": ["-x", "map-ont", "--max_min_gap", "100"],
    "secondary_no": [*SR, "--secondary=no"], "secondary_yes": [*SR, "-N", "3", "--secondary", "yes"],
    "sort_radix": [*SR, "--sort", "radix"], "sort_heap": [*SR, "--sort=heap"],
    "sort_merge": [*SR, "--sort", "merge"], "batch": [*SR, "--batch", "10M"],
    "frag_no": [*SR, "--frag=no"], "frag_yes": ["-x", "map-ont", "--frag=yes"],
    "mesh": [*SR, "--mesh", "2x2"], "mesh_1d": [*SR, "--mesh=4"],
    "split_reads": ["-x", "map-ont", "--split-reads", "30k"],
    "print_seeds": [*SR, "-t", "4", "--print-seeds"],
    "variant_long": [*SR, "--variant", "long"], "variant_short": ["-x", "map-ont", "--variant=sr"],
    "x_map_pb": ["-x", "map-pb"], "x_asm5": ["-x", "asm5"], "x_short": ["-x", "short"],
    "x_none": ["-k", "15"], "W1": [*SR, "-W", "1"],
    "warned": [*SR, "-S", "-D", "-X", "-P", "-u", "b", "-R", "x", "-C", "5",
               "--max-chain-skip", "10", "--junc-bonus=9", "--rmq"],
}


def _parse(main, runtime_mod, dbg, monkeypatch, argv):
    seen = {}

    def record(io, mo, variant, **kw):
        seen.update(io=dataclasses.asdict(io), mo=dataclasses.asdict(mo),
                    variant=variant, print_seeds=dbg.enabled(), **kw)
        return 0

    monkeypatch.setattr(runtime_mod, "run_mapping", record)
    try:
        assert main(argv) == 0
    finally:
        dbg.set_print_seed(False)
    return seen


@pytest.mark.parametrize("opts", list(CASES.values()), ids=list(CASES))
def test_options_parse_equal(monkeypatch, opts):
    argv = [*opts, *FILES]
    mine = _parse(cli.main, runtime, debug, monkeypatch, argv)
    ref = _parse(jax_cli.main, jax_runtime, jax_debug, monkeypatch, argv)
    assert mine.pop("device") == "cuda"  # the port's own option, default
    assert mine == ref


def test_help_and_version(capsys):
    for argv in (["-h"], ["--help"], ["-V"], ["--version"], [*SR, "-V", *FILES]):
        assert cli.main(argv) == 0 and jax_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "--device" in out and out.count(jax_cli.__version__) >= 3


def test_device_option(monkeypatch):
    seen = _parse(cli.main, runtime, debug, monkeypatch, ["--device", "cpu", *SR, *FILES])
    assert seen["device"] == "cpu" and seen["queries"] == FILES[1:]
    seen = _parse(cli.main, runtime, debug, monkeypatch, [*SR, "--device=cuda:1", *FILES])
    assert seen["device"] == "cuda:1"
