"""The port's route imports no JAX: the golden mappings (single-end, and
paired-end with the folded DP) run in a subprocess with
``sys.modules["jax"] = None`` set before anything else, so any ``import
jax`` on the path would fail. The host modules of gdiet_tpu are then
reached through bare parent packages (``gdiet_tpu_torch._host``).
"""

import os
import pathlib
import subprocess
import sys

from gdiet_tpu_torch.testing import r1_vs_single_end, sam_body

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import runpy
sys.argv = ["gdiet_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("gdiet_tpu_torch", run_name="__main__")
except SystemExit as e:
    if e.code not in (0, None):
        raise
from gdiet_tpu_torch import _host
assert _host.MODE == "bare", _host.MODE
assert sys.modules["jax"] is None and sys.modules["jaxlib"] is None
assert not hasattr(sys.modules["gdiet_tpu"], "__file__")
print("NOJAX_OK")
"""


ARGS = ["--device", "cpu", "-a", "-t", "1", "-x", "sr", "-Z", "10",
        "-W", "2", "-k", "21", "-w", "11", "-i", "2", "-N", "1",
        "-r", "0.05,150,200", "-n", "0.95,0.3", "-s", "100",
        "--AF_max_loc", "2", "-v", "1"]


def _run_without_jax(args, env=None):
    res = subprocess.run([sys.executable, "-c", SCRIPT, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NOJAX_OK" in res.stdout


def test_cli_golden_without_jax(data_dir, tmp_path):
    out = tmp_path / "out.sam"
    _run_without_jax([*ARGS, "-o", str(out), str(data_dir / "ref.fa"),
                      str(data_dir / "reads.fq")])
    assert sam_body(out) == sam_body(data_dir / "golden.sam")


def test_pe_cli_without_jax(data_dir, tmp_path):
    """The PE CLI with GDIET_DP_FOLD=1: R1 records match the reference's
    single-end golden except for what pairing rewrites (FLAG PE bits,
    MAPQ, mate columns), as tests/test_pe_parity.py checks them."""
    out = tmp_path / "pe.sam"
    _run_without_jax([*ARGS, "-o", str(out), str(data_dir / "ref_pe.fa"),
                      str(data_dir / "reads_pe_1.fq"), str(data_dir / "reads_pe_2.fq")],
                     env={**os.environ, "GDIET_DP_FOLD": "1"})
    n_checked, bad = r1_vs_single_end(sam_body(out),
                                      sam_body(data_dir / "golden_pe_r1.sam"))
    assert not bad, bad[:5]
    assert n_checked > 200
