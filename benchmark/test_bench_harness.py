"""CPU tests of the benchmark: its files found by name, its names and
units, the traffic generator, the reference against the scalar oracle and
the port's plain path, the control, the planted faults, and the imports.

    python -m pytest benchmark/ -q

Every run here maps on the CPU with the port's plain versions at a tiny
genome; the card's numbers come from ``benchmark/run.py`` on the chip.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from benchmark import genome, roofline, run as R, traffic
from benchmark.reference import refindex, sketch as osk

BENCH = pathlib.Path(__file__).resolve().parent
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CELLS = {c["name"]: c for c in SPEC["workloads"]}


def tiny(cell_name: str, reads=None):
    """A cell's config and mix cut to a 0.6 Mbp genome and a few reads of
    0.9-1.4 kb, all within the long-read mapper's device envelope."""
    cell = CELLS[cell_name]
    cfg = R.load_json(BENCH / "configs" / f"{cell['config']}.json")
    cfg["genome_mbp"] = 0.6
    mix = R.load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    mix["length"].update(min=900, max=1400, median=1100)
    mix.update(window_reads_per_s=2 * (reads or 4))
    return cfg, mix


def run_tiny(cell_name="pacbio_hifi.wgs", seed=11, trace=False, **kw):
    cfg, mix = tiny(cell_name, **kw)
    return R.run(cfg, mix, seed, 0.5, trace, R.cell_metrics(SPEC, cell_name, "end_to_end"),
                 R.cell_metrics(SPEC, cell_name, "per_layer"), device="cpu")


# ---------------------------------------------------------------------------
# files and names
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = next(x for x in SPEC["workloads"] if x["name"] == cell)
    cfg = next(x for x in SPEC["configs"] if x["name"] == c["config"])
    assert (BENCH.parent / cfg["file"]).is_file()
    assert cfg["file"] == f"benchmark/configs/{c['config']}.json"
    assert (BENCH / "traffic" / f"{c['traffic']}.json").is_file()
    for m in R.cell_metrics(SPEC, cell, "per_layer"):
        assert callable(R.load_metric(m["name"]).read)
    assert {m["name"] for m in R.cell_metrics(SPEC, cell, "end_to_end")} >= {"setup_s"}
    assert R.cell_metrics(SPEC, cell, "per_layer")


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in SPEC["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mix", sorted({c["traffic"] for c in SPEC["workloads"]}))
def test_traffic_repeats_under_one_seed(mix):
    cfg = {"genome_mbp": 0.5}
    m = R.load_json(BENCH / "traffic" / f"{mix}.json")
    m["length"].update(median=2000, min=1000, max=4000)

    def draw(seed):
        seqs = genome.make_genome(cfg, seed)
        return traffic.fastq(traffic.Traffic(m, seqs, seed).reads(20, 5))

    a, b, c = draw(2**31 + 3), draw(2**31 + 3), draw(2**31 + 4)
    assert a == b
    assert a != c
    assert a.count(b"\n") == 80


def test_reads_follow_the_mix():
    seqs = genome.make_genome({"genome_mbp": 0.7}, 5)
    assert [n for n, _ in seqs] == genome.GRCH38_NAMES
    assert sum(len(c) for _, c in seqs) == 700_000
    m = R.load_json(BENCH / "traffic" / "hifi_wgs.json")
    tr = traffic.Traffic(m, seqs, 5)
    lens = np.array([len(r) for r in tr.reads(300, 5)])
    assert lens.min() >= 4950 and lens.max() <= 30100
    assert 13500 < np.median(lens) < 16500
    assert 0.85 < (lens > 8192).mean() < 1.0
    # the warm call's reads: the same lengths, those within the envelope
    # and the shortest over it
    want = np.sort(tr._lengths(300, traffic.rng(5, 3)))
    warm = np.sort([len(r) for r in tr.reads(300, 3, max_len=8192)])
    n_in = int((want <= 8192).sum())
    assert len(warm) == n_in + 1
    assert abs(warm[-1] - want[n_in]) < 0.02 * want[n_in]


def test_check_compares_every_device_read_and_a_sample_of_the_rest():
    lens = np.array([9000, 7000, 12000, 6000, 15000, 20000, 8192, 30000])
    mix = {"check_reads": 3}
    a = R.sample_ids(mix, 4, lens, 8192)
    assert set(a) >= {1, 3, 6} and len(a) == 6
    assert a.tolist() == R.sample_ids(mix, 4, lens, 8192).tolist()
    assert {tuple(R.sample_ids(mix, s, lens, 8192)) for s in range(8)} != {tuple(a)}


@pytest.mark.parametrize("check_reads", [0, 3, 50])
def test_check_compares_every_read_with_the_envelope_at_the_longest(check_reads):
    lens = np.array([9000, 7000, 12000, 6000, 15000, 20000, 8192, 30000])
    for lmax in (30000, 30001, 40000):
        got = R.sample_ids({"check_reads": check_reads}, 4, lens, lmax)
        assert got.tolist() == list(range(len(lens)))


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w,k,pattern", [(11, 21, "10"), (19, 19, "10"), (5, 7, "110")])
def test_numpy_sketch_equals_the_scalar_scan(w, k, pattern):
    g = np.random.default_rng(k)
    for trial in range(12):
        n = int(g.integers(10, 2500))
        c = g.integers(0, 4, n).astype(np.uint8)
        if trial % 3 == 0:  # tandem repeats: ties in a window
            unit = g.integers(0, 4, int(g.integers(1, 8))).astype(np.uint8)
            st, ln = int(g.integers(0, n)), int(g.integers(0, 400))
            c[st: st + ln] = np.tile(unit, ln // len(unit) + 1)[: max(0, min(ln, n - st))]
        if trial % 2 == 0:  # N runs
            for _ in range(int(g.integers(0, 5))):
                st = int(g.integers(0, n))
                c[st: st + int(g.integers(1, 40))] = 4
        want = sorted((x >> 8, y) for x, y in osk.sketch_index(c, w, k, 3, pattern))
        ks, ys = refindex.sketch_sequence(c, w, k, 3, pattern)
        assert sorted(zip(ks.tolist(), ys.tolist())) == want


def test_reference_index_equals_the_program_index():
    import torch

    from gdiet_tpu_torch.index.build import build_index
    from benchmark.reference import options as ropt

    cfg = R.load_json(BENCH / "configs" / "pacbio_hifi_z10.json")
    seqs = genome.make_genome({"genome_mbp": 0.5}, 9)
    io, _, _, _ = ropt.parse(cfg["args"])
    ref = refindex.RefIndex(seqs, io.w, io.k, io.pattern)
    pio = R.program_options(cfg["args"], "cpu")[0]
    mi = build_index(seqs, pio, torch.device("cpu"))
    assert refindex.entry_diff(mi.keys, mi.starts, mi.positions,
                               ref.keys, ref.starts, ref.positions) == 0
    ctl = refindex.RefIndex(seqs, io.w, io.k, io.pattern, key_bits=32)
    assert refindex.entry_diff(ctl.keys, ctl.starts, ctl.positions,
                               ref.keys, ref.starts, ref.positions) > len(ref.positions)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_agrees_with_the_plain_path(cell):
    res = run_tiny(cell)
    assert res["checks"]["index_diff"]["value"] == 0
    assert res["checks"]["wrong_reads"]["value"] == 0
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] == 4


def test_traced_run_reads_its_metrics():
    res = run_tiny(trace=True)
    assert "index_build_s" in res["metrics"]
    assert 0.0 <= res["metrics"]["fallback_pct.lr"]["value"] <= 100.0
    assert "front_ms.lr" in res["metrics"] and "host_tail_ms.lr" in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("saturation", [0, 127])
def test_pooled_reference_maps_as_the_serial_one(saturation, monkeypatch):
    """The pool's lines, read by read in ``pick``'s order, equal the lines
    of one thread; the control's saturation holds in every worker. More
    workers than cores, and the interpreter switching threads often."""
    import os

    from benchmark.reference import native as rnative, options as ropt

    cfg, mix = tiny("pacbio_hifi.wgs")
    mix["length"].update(min=600, max=2400, median=1200)
    seqs = genome.make_genome(cfg, 13)
    io, mo, _, _ = ropt.parse(cfg["args"])
    ref = refindex.RefIndex(seqs, io.w, io.k, io.pattern)
    mid = ref.mid_occ(mo)
    reads = traffic.Traffic(mix, seqs, 13).reads(12, 5)
    pick = np.array([9, 0, 4, 11, 2, 7, 5])
    monkeypatch.setattr(R, "REF_WORKERS", 3 * (os.cpu_count() or 1))
    switch = sys.getswitchinterval()
    rnative.set_saturation(saturation)
    try:
        serial = [R.reference_lines(ref, mo, mid, traffic.name(i), traffic.seq(reads[i]))
                  for i in pick]
        sys.setswitchinterval(1e-6)
        pooled = R.reference_map(ref, mo, mid, reads, pick)
    finally:
        sys.setswitchinterval(switch)
        rnative.set_saturation(0)
    assert pooled == serial
    assert [ls[0].split("\t")[0] for ls in pooled] == [traffic.name(i) for i in pick]
    if saturation:  # the control's lines are not the reference's
        assert pooled != R.reference_map(ref, mo, mid, reads, pick)


@pytest.fixture(scope="module")
def tiny_window():
    """check's arguments as a tiny run passes them: a real window."""
    seen = []
    orig = R.check
    R.check = lambda *a, **kw: seen.append(a) or orig(*a, **kw)
    try:
        run_tiny(reads=8)
    finally:
        R.check = orig
    return seen[0]


def _plant(sam: bytes, ids, starts, ends, read: int) -> bytes:
    """``read``'s first SAM line with its POS moved by one."""
    j = int(np.flatnonzero(ids == read)[0])
    f = sam[starts[j]:ends[j]].split(b"\t")
    f[3] = str(int(f[3]) + 1).encode()
    return sam[:starts[j]] + b"\t".join(f) + sam[ends[j]:]


@pytest.mark.parametrize("planted", [False, True])
def test_pooled_check_counts_as_serial_lines(tiny_window, planted):
    """With the envelope above every read, the check compares every read
    and counts, on its pool, the reads whose lines differ from the
    reference's mapped one by one; one read's lines planted wrong count 1."""
    from benchmark.reference import options as ropt

    cfg, mix, seqs, reads, ids, starts, ends, sam, seed, prog_index, _ = tiny_window
    lmax = max(len(r) for r in reads)
    if planted:
        sam = _plant(sam, ids, starts, ends, 5)
        ids, starts, ends = R.parse_sam(sam)
    io, mo, _, _ = ropt.parse(cfg["args"])
    ref = refindex.RefIndex(seqs, io.w, io.k, io.pattern)
    mid = ref.mid_occ(mo)
    serial = 0
    for i in range(len(reads)):
        got = [sam[a:b].decode() for a, b in zip(starts[ids == i], ends[ids == i])]
        serial += got != R.reference_lines(ref, mo, mid, traffic.name(i),
                                           traffic.seq(reads[i]))
    checks = R.check(cfg, mix, seqs, reads, ids, starts, ends, sam, seed, prog_index, lmax)
    assert len(R.sample_ids(mix, seed, np.array([len(r) for r in reads]), lmax)) == len(reads)
    assert checks["wrong_reads"]["value"] == serial == int(planted)
    assert checks["index_diff"]["value"] == 0


# ---------------------------------------------------------------------------
# the roofline count
# ---------------------------------------------------------------------------
def _band_cells_loop(q, t, w, r_end):
    n = 0
    for r in range(r_end + 1):
        st = max(0, r - q + 1, (r - w + 1) >> 1)
        en = min(t - 1, r, (r + w) >> 1)
        n += max(0, en - st + 1)
    return n


def test_roofline_work_from_lengths_band_and_end_cell():
    q = np.array([150, 0, 37, 512, 3000])
    t = np.array([150, 0, 80, 1024, 3100])
    w = np.array([150, 150, 40, -1, 1000])
    got = roofline.band_cells(q, t, w, q + t - 2)
    want = [_band_cells_loop(a, b, c if c >= 0 else max(a, b), a + b - 2) if a and b else 0
            for a, b, c in zip(q, t, w)]
    assert got.tolist() == want
    fi, fj = np.array([-1, 0, -1, 3, -1]), np.array([-1, 0, 2, -1, 5])
    ops, byt = roofline.work([(q, t, w, fi, fj)])
    assert ops == sum(want) * roofline.OPS_PER_CELL
    live = (q > 0) & (t > 0)
    assert byt == int((q + t + 4 + np.maximum(t - 1 - fi, q - 1 - fj))[live].sum())


def test_roofline_work_is_the_same_for_int32_and_int16():
    """The plain int32 and int16 lane states, on the same rows, give the
    same end cells and so the same work."""
    import torch

    from gdiet_tpu_torch.ops import extd2

    g = np.random.default_rng(3)
    N, L = 12, 160
    tgt = g.integers(0, 4, (N, L)).astype(np.uint8)
    qry = tgt.copy()
    for i in range(N):  # a few substitutions and one shifted tail a row
        qry[i, g.integers(0, L, 4)] = g.integers(0, 4, 4)
        cut = int(g.integers(20, L - 20))
        qry[i, cut:] = np.roll(qry[i, cut:], 1)
    lens = torch.from_numpy(g.integers(100, L + 1, N).astype(np.int32))
    band = torch.full((N,), 150, dtype=torch.int32)
    params = (2, 8, 12, 2, 24, 1)
    rows = []
    for sd in ("int32", "int16"):
        _, dirs, _, _ = extd2.extd2_batch(torch.from_numpy(qry), torch.from_numpy(tgt), lens,
                                          band, params, L, state_dtype=sd)
        _, fi, fj = extd2.backtrack_band(dirs, lens, lens, band, L, L)
        rows.append((lens.numpy(), None, band.numpy(), fi.numpy(), fj.numpy()))
    assert np.array_equal(rows[0][3], rows[1][3]) and np.array_equal(rows[0][4], rows[1][4])
    assert roofline.work(rows[:1]) == roofline.work(rows[1:])
    assert roofline.work(rows[:1])[0] > 0


def test_roofline_share_is_against_the_packed_peak():
    q = np.array([5000]); t = np.array([5200]); w = np.array([1000])
    rows = [(q, t, w, np.array([-1]), np.array([4]))]
    card = {"sms": 132, "max_sm_clock_mhz": 1980.0}
    ops, _ = roofline.work(rows)
    ctx = {"dp_rows": rows, "dp_device_s": 0.01, "card": card}
    peak = 2 * 132 * 64 * 1980e6
    assert roofline.share(ctx) == pytest.approx(100 * ops / peak / 0.01)
    assert roofline.share({**ctx, "dp_device_s": None}) is None


# ---------------------------------------------------------------------------
# the control and the planted faults
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    cfg, mix = tiny(cell, reads=8)
    seqs = genome.make_genome(cfg, 11)
    res = R.run_control(cfg, mix, seqs, traffic.Traffic(mix, seqs, 11), 11, 0.5)
    assert res["correct"] is False
    assert res["checks"]["index_diff"]["value"] > 0
    assert res["checks"]["wrong_reads"]["value"] > 0


def _drop_half(results):
    mapped = [i for i, r in enumerate(results) if r]
    for i in mapped[::2]:
        results[i] = []
    return results


def _alter(results):
    for regs in results:
        for r in regs or []:
            r.rs += 1
            r.re += 1
    return results


@pytest.mark.parametrize("fault", [_drop_half, _alter])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    """The long-read mapper's answers broken where they are produced:
    half of each batch's mapped reads left out, or every position moved."""
    from gdiet_tpu_torch.pipeline import longread

    tail = longread.LongReadMapper._tail_batch
    monkeypatch.setattr(longread.LongReadMapper, "_tail_batch",
                        lambda self, st: fault(tail(self, st)))
    res = run_tiny(reads=8)
    assert res["correct"] is False
    assert res["checks"]["wrong_reads"]["value"] > 0


def test_missing_records_are_not_correct(monkeypatch):
    """Half of the window's SAM lines lost on the way out."""
    close = R.SamPipe.close

    def half(self):
        return b"\n".join(close(self).split(b"\n")[::2]) + b"\n"

    monkeypatch.setattr(R.SamPipe, "close", half)
    res = run_tiny(reads=8)
    assert res["failed"] > 0
    assert res["correct"] is False


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------
def test_no_jax_in_the_benchmark_sources():
    bad = []
    for p in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad += [(p.name, n) for n in names if n.split(".")[0] in R.FORBIDDEN]
    assert bad == []


def test_no_jax_loaded_by_a_run():
    code = ("import sys; sys.argv = ['x']; from benchmark import test_bench_harness as T; "
            "T.run_tiny(); from benchmark import run as R; "
            "print('LOADED', R.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=600)
    assert "LOADED []" in out.stdout, out.stderr[-3000:]


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert all(m.split(".")[0] in ("benchmark", "numpy", "__future__", "ctypes",
                                           "hashlib", "os", "pathlib", "subprocess", "sys",
                                           "math", "heapq", "time", "dataclasses",
                                           "functools", "threading", "collections",
                                           "contextlib", "enum", "multiprocessing",
                                           "concurrent") for m in mods), (p.name, mods)
