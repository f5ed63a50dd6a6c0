"""The port stands alone: it imports neither JAX nor the JAX package.

An AST walk over every module of ``gdiet_tpu_torch`` (``parallel/``
included) and over ``chip_smoke.py`` finds no import of ``jax`` or
``gdiet_tpu`` (comments and docstrings may name the JAX files), and one
over ``gdiet_tpu_torch/ops/`` no import of the layers above the kernels.
The single-end (also on a ``--mesh 2x2`` virtual CPU mesh), paired-end,
generic (``--MD --cs`` SAM, ``-c`` PAF) and long-read CLIs then run in a
subprocess with ``sys.modules["jax"]``, ``["jaxlib"]`` and
``["gdiet_tpu"]`` set to None before anything else, so any such import on
their path would fail, and each writes the same SAM as the port's run in
this process, where both packages are loaded.
"""

import ast
import os
import pathlib
import subprocess
import sys

import gdiet_tpu  # noqa: F401  (the in-process runs have both packages loaded)
import pytest

from gdiet_tpu_torch import cli
from gdiet_tpu_torch.testing import r1_vs_single_end, sam_body, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "gdiet_tpu"):
    sys.modules[name] = None
import runpy
sys.argv = ["gdiet_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("gdiet_tpu_torch", run_name="__main__")
except SystemExit as e:
    if e.code not in (0, None):
        raise
assert all(sys.modules[n] is None for n in ("jax", "jaxlib", "gdiet_tpu"))
assert not [n for n in sys.modules if n.startswith(("jax.", "gdiet_tpu."))]
print("NOJAX_OK")
"""


ARGS = ["--device", "cpu", "-a", "-t", "1", "-x", "sr", "-Z", "10",
        "-W", "2", "-k", "21", "-w", "11", "-i", "2", "-N", "1",
        "-r", "0.05,150,200", "-n", "0.95,0.3", "-s", "100",
        "--AF_max_loc", "2", "-v", "1"]
HIFI_ARGS = ["--device", "cpu", "-a", "-t", "1", "-x", "map-hifi", "-Z", "10",
             "-W", "2", "-k", "19", "-w", "19", "-i", "0.2", "-r", "200",
             "--vt_dis=650", "--vt_nb_loc=5", "--vt_df1=0.0106", "--vt_df2=0.2",
             "-s", "100", "--vt_cov", "0.04", "--vt_f=0.04", "-v", "1"]


def _imports(path: pathlib.Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_gdiet_tpu():
    files = sorted((ROOT / "gdiet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30 and ROOT / "gdiet_tpu_torch" / "api.py" in files
    assert ROOT / "gdiet_tpu_torch" / "parallel" / "dist.py" in files
    bad = [(str(f.relative_to(ROOT)), n) for f in files for n in _imports(f)
           if n.split(".")[0] in ("jax", "jaxlib", "gdiet_tpu")]
    assert not bad, bad


def _imports_resolved(path: pathlib.Path) -> list:
    """Every module ``path`` imports, at any depth (inside functions too),
    relative imports resolved, and each name of a ``from X import name``
    as ``X.name`` besides ``X``."""
    pkg = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = pkg.rsplit(".", node.level - 1)[0] if node.level else ""
            mod = ".".join(p for p in (base, node.module) if p)
            names += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return names


def test_ops_import_nothing_above_them():
    """The kernel layer stands on its own: no module under
    ``gdiet_tpu_torch/ops/`` imports the layers that call it."""
    files = sorted((ROOT / "gdiet_tpu_torch" / "ops").glob("*.py"))
    assert ROOT / "gdiet_tpu_torch" / "ops" / "vote.py" in files
    above = tuple(f"gdiet_tpu_torch.{m}" for m in ("pipeline", "parallel", "runtime",
                                                   "api", "cli"))
    bad = [(f.name, n) for f in files for n in _imports_resolved(f)
           if any(n == a or n.startswith(a + ".") for a in above)]
    assert not bad, bad


def _run_without_jax(args):
    # one OpenMP thread, as the in-process runs (see testing.torch_threads)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", SCRIPT, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NOJAX_OK" in res.stdout


def _run_here(args, out):
    """The same CLI in this process, where JAX and gdiet_tpu are loaded."""
    assert "gdiet_tpu" in sys.modules and "jax" in sys.modules
    assert cli.main([*args, "-o", str(out)]) == 0
    return sam_body(out)


def test_cli_golden_without_jax(data_dir, tmp_path):
    out = tmp_path / "out.sam"
    inputs = [str(data_dir / "ref.fa"), str(data_dir / "reads.fq")]
    _run_without_jax([*ARGS, "-o", str(out), *inputs])
    assert sam_body(out) == sam_body(data_dir / "golden.sam")
    assert sam_body(out) == _run_here([*ARGS, *inputs], tmp_path / "here.sam")


def test_mesh_cli_without_jax(data_dir, tmp_path):
    """The single-end CLI on a 2x2 virtual CPU mesh (parallel/dist.py)."""
    out = tmp_path / "mesh.sam"
    args = [*ARGS, "--mesh", "2x2"]
    inputs = [str(data_dir / "ref.fa"), str(data_dir / "reads.fq")]
    _run_without_jax([*args, "-o", str(out), *inputs])
    assert sam_body(out) == sam_body(data_dir / "golden.sam")
    assert sam_body(out) == _run_here([*args, *inputs], tmp_path / "here.sam")


def test_pe_cli_without_jax(data_dir, tmp_path):
    """The PE CLI: R1 records match the reference's
    single-end golden except for what pairing rewrites (FLAG PE bits,
    MAPQ, mate columns), as tests/test_pe_parity.py checks them."""
    out = tmp_path / "pe.sam"
    inputs = [str(data_dir / "ref_pe.fa"), str(data_dir / "reads_pe_1.fq"),
              str(data_dir / "reads_pe_2.fq")]
    _run_without_jax([*ARGS, "-o", str(out), *inputs])
    n_checked, bad = r1_vs_single_end(sam_body(out),
                                      sam_body(data_dir / "golden_pe_r1.sam"))
    assert not bad, bad[:5]
    assert n_checked > 200
    assert sam_body(out) == _run_here([*ARGS, *inputs], tmp_path / "here.sam")


@pytest.mark.parametrize("opts,suffix", [(["-a", "--MD", "--cs"], "sam"), (["-c"], "paf")])
def test_generic_cli_without_jax(data_dir, tmp_path, opts, suffix):
    """The generic per-record writer: SAM with MD/cs tags, and PAF."""
    args = [*opts, *[a for a in ARGS if a != "-a"]]
    out = tmp_path / f"out.{suffix}"
    inputs = [str(data_dir / "ref.fa"), str(data_dir / "reads.fq")]
    _run_without_jax([*args, "-o", str(out), *inputs])
    mine = sam_body(out)
    assert len(mine) >= 40 and mine == _run_here([*args, *inputs], tmp_path / "here")


@pytest.fixture
def lr_subset(data_dir, tmp_path):
    """The first 8 reads of the long-read fixture."""
    sub = tmp_path / "reads_lr8.fq"
    sub.write_text("\n".join((data_dir / "reads_lr.fq").read_text().splitlines()[:32]) + "\n")
    return sub


def test_lr_cli_without_jax(data_dir, tmp_path, lr_subset):
    out = tmp_path / "lr.sam"
    inputs = [str(data_dir / "ref_lr.fa"), str(lr_subset)]
    _run_without_jax([*HIFI_ARGS, "-o", str(out), *inputs])
    keep = {f"lr{i}" for i in range(8)}
    golden = [l for l in sam_body(data_dir / "golden_lr_hifi.sam")
              if l.split("\t")[0] in keep]
    assert sam_body(out) == golden
    assert sam_body(out) == _run_here([*HIFI_ARGS, *inputs], tmp_path / "here.sam")
