"""The port's ``GDIET_COORDINATOR`` join, the counterpart of
tests/test_multihost.py.

Two processes join one gloo process group through ``GDIET_COORDINATOR`` (a
free local port), ``GDIET_NUM_PROCESSES`` and ``GDIET_PROCESS_ID``; each
maps its half of ``reads.fq`` through the port's CLI on the CPU with
``jax``, ``jaxlib`` and ``gdiet_tpu`` blocked, as tests/test_torch_nojax.py
blocks them. Both exit 0 and report a group of 2, and their records
concatenated equal ``golden.sam``.
"""

import os
import pathlib
import socket
import subprocess
import sys

from gdiet_tpu_torch.testing import sam_body

ROOT = pathlib.Path(__file__).resolve().parent.parent

WORKER = r"""
import sys
for name in ("jax", "jaxlib", "gdiet_tpu"):
    sys.modules[name] = None
from gdiet_tpu_torch.cli import main
rc = main(sys.argv[1:])
assert not [n for n in sys.modules if n.startswith(("jax.", "gdiet_tpu."))]
sys.exit(rc)
"""

ARGS = ["--device", "cpu", "-a", "-t", "1", "-x", "sr", "-Z", "10", "-W", "2", "-k", "21",
        "-w", "11", "-i", "2", "-N", "1", "-r", "0.05,150,200", "-n", "0.95,0.3",
        "-s", "100", "--AF_max_loc", "2", "-v", "3"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_join(data_dir, tmp_path):
    lines = (data_dir / "reads.fq").read_text().splitlines()
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    half = len(recs) // 2
    coordinator = f"127.0.0.1:{free_port()}"
    procs, outs = [], []
    for p, shard in enumerate((recs[:half], recs[half:])):
        fq = tmp_path / f"shard{p}.fq"
        fq.write_text("\n".join(l for rec in shard for l in rec) + "\n")
        out = tmp_path / f"out{p}.sam"
        outs.append(out)
        env = {**os.environ, "GDIET_COORDINATOR": coordinator, "GDIET_NUM_PROCESSES": "2",
               "GDIET_PROCESS_ID": str(p), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, *ARGS, "-o", str(out), str(data_dir / "ref.fa"),
             str(fq)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errs = []
    try:
        for p, pr in enumerate(procs):
            _, err = pr.communicate(timeout=300)
            errs.append(err)
            assert pr.returncode == 0, err[-3000:]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for p, err in enumerate(errs):
        assert f"joined torch.distributed (gloo) as process {p} of 2" in err, err[-3000:]
    got = [l for out in outs for l in sam_body(out)]
    assert got == sam_body(data_dir / "golden.sam")
