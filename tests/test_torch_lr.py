"""Port long-read path vs gdiet_tpu's, on the CPU.

- The LR device front: the port's ``lr_front`` packed meta [B, 4 + 8K + 4 +
  16] equals JAX's ``lr_front`` under ``jax.jit`` for the HiFi fixture, at
  the budgets of ``tests/test_longread_device.py``. Both map against the
  same ``DietIndex``, carried across with ``TorchIndex.from_numpy``; each
  side builds its options with its own ``options_for``.
- The slice: ``python -m gdiet_tpu_torch --device cpu`` with the fixture's
  HiFi and ONT arguments (``tests/data/make_lr_fixtures.py``) on the first
  8 reads of ``reads_lr.fq`` writes the reference binary's golden records
  for those reads and the body ``gdiet_tpu.cli.main`` writes. On the CPU
  this runs the port's plain banded DP and backtrack end to end.
"""

import numpy as np
import pytest

from gdiet_tpu_torch import cli
from gdiet_tpu_torch.index.build import TorchIndex
from gdiet_tpu_torch.ops import dp_band, extd2
from gdiet_tpu_torch.testing import sam_body, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


HIFI = dict(pattern="10", k=19, w=19, max_seeds=0.2, bw=200, vt_dis=650,
            vt_nb_loc=5, vt_df1=0.0106, vt_df2=0.2, min_dp_max=100,
            vt_cov=0.04, vt_f=0.04)
BUDGETS = dict(max_read_len=4096, seed_budget=512, shift_seed_budget=128,
               hit_budget=1024)

HIFI_ARGS = ["-a", "-t", "1", "-x", "map-hifi", "-Z", "10", "-W", "2", "-k", "19",
             "-w", "19", "-i", "0.2", "-r", "200", "--vt_dis=650", "--vt_nb_loc=5",
             "--vt_df1=0.0106", "--vt_df2=0.2", "-s", "100", "--vt_cov", "0.04",
             "--vt_f=0.04", "-v", "1"]
ONT_ARGS = ["-a", "-t", "1", "-x", "map-ont", "-Z", "10", "-W", "2", "-k", "15",
            "-w", "10", "-r", "300", "--vt_dis=1000", "--vt_nb_loc=3",
            "--vt_df1=0.007", "--vt_df2=0.007", "-s", "100", "--vt_cov", "0.1",
            "-v", "1"]


@pytest.fixture(scope="module")
def hifi_index(data_dir):
    from gdiet_tpu.config import options_for
    from gdiet_tpu.index import build_index
    from gdiet_tpu.io.fastx import read_fastx

    io_, mo = options_for("map-hifi", variant="lr", **HIFI)
    refs = [(r.name, r.seq) for r in read_fastx(str(data_dir / "ref_lr.fa"))]
    return build_index(refs, io_), mo


def test_lr_front_matches_jax(data_dir, hifi_index):
    from gdiet_tpu.pipeline.longread import LongReadMapper as JaxMapper
    from gdiet_tpu_torch.config import options_for
    from gdiet_tpu_torch.io.fastx import read_fastx
    from gdiet_tpu_torch.pipeline.longread import LongReadMapper

    jmi, jmo = hifi_index
    _, mo = options_for("map-hifi", variant="lr", **HIFI)
    reads = list(read_fastx(str(data_dir / "reads_lr.fq")))
    lens = np.array([r.l_seq for r in reads], np.int64)
    jax_front = JaxMapper(jmi, jmo, **BUDGETS)
    ref = np.asarray(jax_front._dispatch_front(reads, lens)[3]["meta"])
    mapper = LongReadMapper(TorchIndex.from_numpy(jmi, "cpu"), mo, device="cpu",
                            **BUDGETS)
    meta = mapper._dispatch_front(reads, lens)[1].numpy()
    assert meta.shape == ref.shape == (len(reads), 4 + 8 * mo.vt_nb_loc + 4 + 16)
    np.testing.assert_array_equal(meta, ref)
    assert (meta[:, 3] > 0).sum() > len(reads) // 2  # candidates kept
    assert (meta[:, -19] > 0).sum() > 8  # round-2 head windows open


@pytest.fixture(scope="module")
def lr_subset(data_dir, tmp_path_factory):
    """The first 8 reads of the long-read fixture and their names."""
    sub = tmp_path_factory.mktemp("lr") / "reads_lr8.fq"
    sub.write_text("\n".join((data_dir / "reads_lr.fq").read_text().splitlines()[:32]) + "\n")
    return sub, {f"lr{i}" for i in range(8)}


@pytest.mark.parametrize("tag,args", [("hifi", HIFI_ARGS), ("ont", ONT_ARGS)])
def test_lr_cli_matches_golden_and_jax(data_dir, tmp_path, lr_subset, tag, args):
    from gdiet_tpu.cli import main as jax_main

    sub, keep = lr_subset
    inputs = [str(data_dir / "ref_lr.fa"), str(sub)]
    calls, launches = dp_band.calls.n, extd2.band_launches.n
    assert cli.main(["--device", "cpu", *args, "-o", str(tmp_path / "port.sam"), *inputs]) == 0
    assert dp_band.calls.n > calls and extd2.band_launches.n == launches
    mine = sam_body(tmp_path / "port.sam")
    golden = [l for l in sam_body(data_dir / f"golden_lr_{tag}.sam")
              if l.split("\t")[0] in keep]
    assert mine == golden
    assert jax_main([*args, "-o", str(tmp_path / "jax.sam"), *inputs]) == 0
    assert mine == sam_body(tmp_path / "jax.sam")
