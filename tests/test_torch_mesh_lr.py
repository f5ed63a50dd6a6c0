"""The port's long-read mesh vs gdiet_tpu, on a virtual CPU mesh.

The long-read front over a (2, 2) mesh of ``"cpu"`` devices
(``parallel/dist.py::sharded_lr_front``): the LR CLI with ``--mesh 2x2``
equals ``gdiet_tpu.cli`` without a mesh on the first 4 fixture reads
(``gdiet_tpu``'s own meshed LR test is marked slow,
tests/test_multichip.py:113), and a (2, 2) ``LongReadMapper``'s front
(63 reads, padded to 64 rows) and SAM (2 reads) equal the single-device
mapper's. Tolerance: exact. The short-read mesh is tests/test_torch_mesh.py's.
"""

import numpy as np
import pytest

from gdiet_tpu_torch import cli
from gdiet_tpu_torch.config import options_for
from gdiet_tpu_torch.io.fastx import read_fastx
from gdiet_tpu_torch.parallel import dist
from gdiet_tpu_torch.pipeline.longread import LongReadMapper
from gdiet_tpu_torch.testing import sam_body, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


HIFI_ARGS = ["-a", "-t", "1", "-x", "map-hifi", "-Z", "10", "-W", "2", "-k", "19",
             "-w", "19", "-i", "0.2", "-r", "200", "--vt_dis=650", "--vt_nb_loc=5",
             "--vt_df1=0.0106", "--vt_df2=0.2", "-s", "100", "--vt_cov", "0.04",
             "--vt_f=0.04", "-v", "1"]
HIFI = dict(pattern="10", k=19, w=19, max_seeds=0.2, bw=200, vt_dis=650, vt_nb_loc=5,
            vt_df1=0.0106, vt_df2=0.2, min_dp_max=100, vt_cov=0.04, vt_f=0.04)


def cpu_mesh(n_data: int, n_ref: int):
    return dist.make_mesh(n_data, n_ref, ["cpu"] * (n_data * n_ref))


@pytest.fixture(scope="module")
def lr_reads4(data_dir, tmp_path_factory):
    """The first 4 reads of the long-read fixture, as a FASTQ."""
    sub = tmp_path_factory.mktemp("lr") / "reads_lr4.fq"
    sub.write_text("\n".join((data_dir / "reads_lr.fq").read_text().splitlines()[:16]) + "\n")
    return sub


def test_lr_cli_mesh_matches_jax(data_dir, tmp_path, lr_reads4):
    from gdiet_tpu.cli import main as jax_main

    inputs = [str(data_dir / "ref_lr.fa"), str(lr_reads4)]
    mine, ref = tmp_path / "port.sam", tmp_path / "jax.sam"
    assert cli.main(["--device", "cpu", *HIFI_ARGS, "--mesh", "2x2", "-o", str(mine),
                     *inputs]) == 0
    assert jax_main([*HIFI_ARGS, "-o", str(ref), *inputs]) == 0
    assert len(sam_body(mine)) >= 4 and sam_body(mine) == sam_body(ref)


def test_lr_mesh_matches_single(data_dir):
    """A (2, 2) LongReadMapper: its front's packed meta equals the
    single-device front's on 63 reads (padded to 64 rows), and its SAM the
    single-device SAM on the first 2 reads."""
    from gdiet_tpu_torch.index import build_index

    io_, mo = options_for("map-hifi", variant="lr", **HIFI)
    mi = build_index([(r.name, r.seq) for r in read_fastx(str(data_dir / "ref_lr.fa"))],
                     io_, "cpu")
    reads = list(read_fastx(str(data_dir / "reads_lr.fq")))[:63]
    kw = dict(max_read_len=4096, seed_budget=512, shift_seed_budget=128, hit_budget=1024)
    meshed = LongReadMapper(mi, mo, mesh=cpu_mesh(2, 2), device="cpu", **kw)
    single = LongReadMapper(mi, mo, device="cpu", **kw)
    lens = np.array([r.l_seq for r in reads], np.int64)
    got = meshed._dispatch_front(reads, lens)[1].numpy()
    np.testing.assert_array_equal(got, single._dispatch_front(reads, lens)[1].numpy())
    assert got.shape[0] == 63 and (got[:, 3] > 0).sum() > 32  # candidates kept
    sam = [[m.regs_to_sam_lines(r, x) for r, x in zip(reads[:2], m.map_batch(reads[:2]))]
           for m in (meshed, single)]
    assert sam[0] == sam[1] and sam[0][0][0].split("\t")[2] != "*"
