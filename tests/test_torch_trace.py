"""The port's span-and-counter recorder (``utils/profile.py``) on the
long-read path, on the CPU.

- Tracing off keeps totals and no intervals; on (``-v 4``, or a collecting
  ``torch.profiler``) every span of ``run_generic``'s long-read route is
  kept and nests inside its parent, and the SAM is unchanged.
- Every oracle read has one ``lr.oracle_read`` span with its reason, and
  the counters add up to the batch.
- At the mapper's own DP buckets every segment of the fixture is finished
  from its packed row (``finish_py_segments`` 0), and the records are the
  golden ones.
- A span and a profiler event share one clock; the recorder emits no
  profiler range.
- The benchmark's span and counter readers (``benchmark/metrics``) on a
  synthetic trace.

The HiFi runs use the first 8 reads of ``reads_lr.fq`` with the LR DP
buckets cut to (512, 1024), so longer segments take the exact host DP
(``lr.host_dp``) and the plain DP stays short on the CPU; the finish's
counters are read at the full buckets. The ``cuda`` test
runs on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_trace.py``.
"""

import contextlib
import dataclasses
import io
import re
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gdiet_tpu_torch import cli, runtime
from gdiet_tpu_torch.io.fastx import read_fastx
from gdiet_tpu_torch.oracle import align as oal
from gdiet_tpu_torch.pipeline import longread
from gdiet_tpu_torch.testing import sam_body, torch_threads
from gdiet_tpu_torch.utils import profile as tprof
from gdiet_tpu_torch.utils.profile import PROFILE, Profiler, Span, self_ns

HIFI_ARGS = ["-a", "-t", "3", "-x", "map-hifi", "-Z", "10", "-W", "2", "-k", "19",
             "-w", "19", "-i", "0.2", "-r", "200", "--vt_dis=650", "--vt_nb_loc=5",
             "--vt_df1=0.0106", "--vt_df2=0.2", "-s", "100", "--vt_cov", "0.04",
             "--vt_f=0.04"]
SMALL_BUCKETS = [(512, 1024)]

# span -> its parent, as the long-read route of run_generic records them
PARENT = {"run.mapper_init": "run", "index.cuckoo_build": "run.mapper_init",
          "run.read": "run", "run.write": "run",
          "lr.front": "run", "lr.front_wait": "run", "lr.host_mid": "run",
          "lr.dp_dispatch": "run", "lr.host_dp": "lr.dp_dispatch",
          "lr.dp_fetch": "run", "lr.dp_wait": "lr.dp_fetch", "lr.finish": "run",
          "lr.oracle": "run", "lr.oracle_read": "lr.oracle"}
ORACLE = {"lr.oracle", "lr.oracle_read"}
# the fixture's reads all fit the device envelope: no oracle spans; the CLI
# builds the index under the "indexing" stage, a root of its own
CLI_SPANS = set(PARENT) - ORACLE | {"run", "indexing"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def hifi(data_dir, tmp_path_factory):
    """The fixture's reads, the golden records, the CLI's options and the
    index built once."""
    from gdiet_tpu_torch.index.build import build_index

    fq = tmp_path_factory.mktemp("trace") / "reads_lr8.fq"
    fq.write_text("\n".join((data_dir / "reads_lr.fq").read_text().splitlines()[:32]) + "\n")
    keep = {f"lr{i}" for i in range(8)}
    golden = [l for l in sam_body(data_dir / "golden_lr_hifi.sam") if l.split("\t")[0] in keep]
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runtime, "run_mapping", lambda io, mo, variant, **kw: seen.update(
            io=io, mo=mo, variant=variant, **kw) or 0)
        cli.main(["--device", "cpu", *HIFI_ARGS, "ref.fa", "reads.fq"])
    ref = str(data_dir / "ref_lr.fa")
    mi = build_index(((r.name, r.seq) for r in read_fastx(ref)), seen["io"],
                     torch.device("cpu"))
    return dict(fq=fq, ref=ref, golden=golden, reads=list(read_fastx(str(fq))), mi=mi, **seen)


@pytest.fixture(scope="module")
def traced(hifi, tmp_path_factory):
    """One ``-v 4`` CLI run of the fixture: its SAM, stderr and spans."""
    out = tmp_path_factory.mktemp("traced") / "v4.sam"
    err = io.StringIO()
    PROFILE.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(longread, "DP_BUCKETS", SMALL_BUCKETS)
        with contextlib.redirect_stderr(err):
            assert cli.main(["--device", "cpu", *HIFI_ARGS, "-v", "4", "-o", str(out),
                             hifi["ref"], str(hifi["fq"])]) == 0
    spans = list(PROFILE.intervals)
    PROFILE.reset()
    assert not PROFILE.enabled  # -v 4 lasts one run
    return dict(sam=sam_body(out), err=err.getvalue(), spans=spans)


def test_untraced_run_keeps_totals_and_no_intervals(hifi, tmp_path, monkeypatch):
    monkeypatch.setattr(longread, "DP_BUCKETS", SMALL_BUCKETS)
    PROFILE.reset()
    assert not PROFILE.tracing()
    assert runtime.run_generic(hifi["mi"], hifi["mo"], hifi["variant"], [str(hifi["fq"])],
                               str(tmp_path / "off.sam"), 3, 1, hifi["cli_line"],
                               time.perf_counter(), torch.device("cpu")) == 0
    assert PROFILE.intervals == []
    assert PROFILE.count["run"] == 1 and PROFILE.count["lr.front"] == 1
    assert PROFILE.ns["run"] >= PROFILE.ns["lr.dp_dispatch"] > 0
    assert PROFILE.tree("run") is None
    assert sam_body(tmp_path / "off.sam") == hifi["golden"]
    PROFILE.reset()


def test_traced_spans_nest_inside_their_parents(traced):
    spans = traced["spans"]
    assert {s.name for s in spans} == CLI_SPANS
    root = next(s for s in spans if s.name == "run")
    for s in spans:
        assert s.start <= s.end
        if s.name in ("run", "indexing"):
            assert s.parent is None
            continue
        assert s.parent.name == PARENT[s.name], s
        assert s.parent.start <= s.start and s.end <= s.parent.end, s
    # one batch: every mapper span carries its id, the runtime's none
    lr = [s for s in spans if s.name.startswith("lr.")]
    assert len({s.batch for s in lr}) == 1 and lr[0].batch is not None
    assert all(s.batch is None for s in spans if not s.name.startswith("lr."))
    assert len({s.thread for s in spans}) == 1
    # siblings of the root do not overlap: each phase of the batch in turn
    top = sorted((s for s in spans if s.parent is root), key=lambda s: s.start)
    assert all(a.end <= b.start for a, b in zip(top, top[1:]))
    assert PROFILE.tree("run") is None  # reset after the run


def test_traced_run_writes_the_golden_records(traced, hifi):
    assert traced["sam"] == hifi["golden"]


def test_v4_report_prints_spans_self_times_and_counters(traced):
    err = traced["err"]
    rows = {m[0]: tuple(map(int, m[1:])) for m in re.findall(
        r"\[PROFILING\] span (\S+): (\d+) ns total, (-?\d+) ns self, (\d+) calls", err)}
    assert set(rows) == CLI_SPANS, err[-3000:]
    spans = traced["spans"]
    for name, (total, own, n) in rows.items():
        mine = [s for s in spans if s.name == name]
        assert n == len(mine) and total == sum(s.end - s.start for s in mine)
        assert 0 <= own <= total
    kids = sum(rows[k][0] for k, p in PARENT.items() if p == "run" and k in rows)
    assert rows["run"][1] == rows["run"][0] - kids
    counters = dict(re.findall(r"\[PROFILING\] counter (\w+): (\d+)", err))
    assert counters["n_reads"] == "8" and counters["front_reads"] == "8"
    assert counters["fallback_reads"] == counters["front_fallback_reads"] == "0"
    assert int(counters["host_dp_segments"]) == rows["lr.host_dp"][2] > 0
    assert "[PROFILING] indexing time: " in err


def _mapper_run(hifi, monkeypatch, reason):
    """One batch of the fixture straight through ``LongReadMapper`` on a
    3-thread pool, traced, with the oracle taking reads for ``reason``."""
    monkeypatch.setattr(longread, "DP_BUCKETS", SMALL_BUCKETS)
    mo, kw = hifi["mo"], {}
    if reason == "len":
        kw["max_read_len"] = 1024
    elif reason == "front":
        kw["hit_budget"] = 32  # the front's hit budget overflows on 5
    else:
        mo = dataclasses.replace(mo, sdust_thres=20)
    m = longread.LongReadMapper(hifi["mi"], mo, n_threads=3, device="cpu", **kw)
    PROFILE.reset()
    # traced by -v 4's flag, or (reason "host_only") by a collecting
    # profiler, which collects on this thread and not on the pool's
    with (profile(activities=[ProfilerActivity.CPU]) if reason == "host_only"
          else contextlib.nullcontext()):
        monkeypatch.setattr(PROFILE, "enabled", reason != "host_only")
        with PROFILE.span("run"):
            results = m.map_batch(hifi["reads"])
    spans = list(PROFILE.intervals)
    PROFILE.reset()
    return m, results, spans


@pytest.mark.parametrize("reason", ["len", "front", "host_only"])
def test_each_oracle_read_is_a_span_with_its_reason(hifi, monkeypatch, reason):
    m, results, spans = _mapper_run(hifi, monkeypatch, reason)
    st = m.stats
    lens = {r.l_seq for r in hifi["reads"]}
    reads = [s for s in spans if s.name == "lr.oracle_read"]
    oracle = [s for s in spans if s.name == "lr.oracle"]
    assert len(reads) == st["fallback_reads"] > 0 and len(oracle) == 1
    assert {s.attrs["reason"] for s in reads} == {reason}
    assert all(s.parent is oracle[0] and s.batch == oracle[0].batch for s in reads)
    assert all(oracle[0].start <= s.start and s.end <= oracle[0].end for s in reads)
    assert all(s.attrs["len"] in lens for s in reads)
    assert st["oracle_bases"] == sum(s.attrs["len"] for s in reads)
    # reads on the pool's threads, their parent given across threads
    assert threading.get_ident() not in {s.thread for s in reads}
    n_len = sum(s.attrs["reason"] in ("len", "host_only") for s in reads)
    assert st["front_reads"] + n_len == st["n_reads"] == len(hifi["reads"])
    assert st["front_fallback_reads"] == sum(s.attrs["reason"] == "front" for s in reads)
    if reason == "len":
        assert {s.attrs["len"] for s in reads} == {n for n in lens if n > 1024}
    assert all(r is not None for r in results)


def test_full_buckets_finish_every_segment_packed(hifi, monkeypatch):
    """At the mapper's own DP buckets no segment of the fixture takes the
    per-record finish, every segment that reaches a Reg is counted, and the
    records are the golden ones."""
    reached = []
    fetch = longread.LongReadMapper._align_jobs_fetch

    def counted(m, ezs, pending):
        out = fetch(m, ezs, pending)
        reached.append(sum(score != oal.NEG_INF for score, _, _ in out))
        return out

    monkeypatch.setattr(longread.LongReadMapper, "_align_jobs_fetch", counted)
    m = longread.LongReadMapper(hifi["mi"], hifi["mo"], n_threads=3, device="cpu")
    results = m.map_batch(hifi["reads"])
    lines = [line for rec, regs in zip(hifi["reads"], results)
             for line in m.regs_to_sam_lines(rec, regs)]
    assert lines == hifi["golden"]
    st = m.stats
    assert st["host_dp_segments"] == st["finish_py_segments"] == 0
    assert st["finish_segments"] == sum(reached) == st["dp_segments"] > 0


def test_span_and_profiler_event_share_one_clock():
    """A span around a CPU op under torch.profiler contains the op's
    profiler interval, and the recorder adds no range of its own."""
    rec = Profiler()
    x = torch.randn(192, 192)
    assert not rec.tracing()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert rec.tracing()
        with rec.span("clock.mm") as sp:
            x @ x
    t1 = time.time_ns()
    assert not rec.tracing()
    assert sp is not None and t0 <= sp.start <= sp.end <= t1
    events = list(prof.profiler.kineto_results.events())
    mm = [e for e in events if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert sp.start <= mm[0].start_ns() <= mm[0].start_ns() + mm[0].duration_ns() <= sp.end
    assert not any("clock" in e.name() for e in events)
    assert rec.intervals == [sp] and rec.count["clock.mm"] == 1


def test_self_time_counts_overlapping_children_once():
    root = Span("a", 0, 100)
    kids = [Span("b", 10, 50, root), Span("b", 30, 70, root), Span("c", 90, 120, root)]
    grandkid = Span("d", 35, 45, kids[1])
    own = self_ns([root, *kids, grandkid])
    assert own == {"a": 100 - 60 - 10, "b": 40 + 30, "c": 30, "d": 10}


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------
T = 1_790_000_000_000_000_000  # ns, Unix epoch
MS = 1_000_000


def _synthetic() -> Profiler:
    """An earlier run, then a run of 1,000 ms: spans cover 0-270 and
    300-950 ms."""
    rec = Profiler()

    def add(name, a, b, parent=None, **attrs):
        s = Span(name, T + a * MS, T + b * MS, parent, 0, 0, attrs)
        rec.intervals.append(s)
        return s

    old = add("run", -5000, -4000)
    add("run.read", -5000, -4500, old)
    run = add("run", 0, 1000)
    for name, a, b in (("run.mapper_init", 0, 100), ("run.read", 100, 110),
                       ("lr.front", 110, 130), ("lr.front_wait", 130, 140),
                       ("lr.host_mid", 140, 200), ("lr.dp_dispatch", 200, 210),
                       ("lr.finish", 260, 270), ("run.write", 900, 950)):
        add(name, a, b, run)
    fetch = add("lr.dp_fetch", 210, 260, run)
    add("lr.dp_wait", 215, 225, fetch)
    add("lr.dp_wait", 230, 240, fetch)
    oracle = add("lr.oracle", 300, 900, run)
    for a, b, n in ((300, 700, 4000), (310, 800, 6000), (320, 900, 2000)):
        add("lr.oracle_read", a, b, oracle, len=n, reason="len")
    rec.ns["index.cuckoo_build"] = 1_500 * MS  # the total of a set-up span
    return rec


# device operations (us): one in the gap at 270-300 ms, one under lr.front
EVENTS = [("kernel", T / 1e3 + 280_000, T / 1e3 + 290_000),
          ("kernel", T / 1e3 + 120_000, T / 1e3 + 125_000)]
CTX = {"window_s": 1.1, "events": EVENTS,
       "stats": {"oracle_bases": 12_000, "front_reads": 4, "front_fallback_reads": 1,
                 "dp_segments": 40, "host_dp_segments": 3, "finish_segments": 37,
                 "finish_py_segments": 3}}
COUNTER_READERS = {"front_fallback_pct.lr", "host_dp_pct.lr", "finish_py_pct.lr"}
EXPECTED = {"parse_ms.lr": 10.0, "write_ms.lr": 50.0, "host_mid_ms.lr": 60.0,
            "oracle_ms.lr": 600.0, "device_wait_ms.lr": 30.0,
            "oracle_ms_per_kbp.lr": (400 + 490 + 580) / 12.0,
            "front_fallback_pct.lr": 25.0, "host_dp_pct.lr": 7.5,
            "finish_py_pct.lr": 100.0 * 3 / 37,
            "cuckoo_build_s": 1.5,
            # covered: 270 + 650 ms of spans, 10 ms of device in a gap
            "idle_unspanned_pct.lr": 100.0 * (1.1 - 0.93) / 1.1}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_trace(name, monkeypatch):
    from benchmark import run as R

    monkeypatch.setattr(tprof, "PROFILE", _synthetic())
    assert R.load_metric(name).read(CTX) == pytest.approx(EXPECTED[name], rel=1e-6)


def test_readers_return_none_without_a_run_root(monkeypatch):
    """An untraced run (or a program without the recorder): nothing to
    read, and no reader raises."""
    from benchmark import run as R

    monkeypatch.setattr(tprof, "PROFILE", Profiler())
    for name in EXPECTED:
        ctx = CTX if name not in COUNTER_READERS else {**CTX, "stats": {}}
        assert R.load_metric(name).read(ctx) is None, name
    monkeypatch.setattr(tprof, "PROFILE", object())
    assert R.load_metric("oracle_ms.lr").read(CTX) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_span_contains_its_kernels():
    """A span around a kernel and a synchronize() contains the kernel's
    device interval on the profiler's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from torch.autograd import DeviceType

    x = torch.randn(4096, 4096, device="cuda")
    x @ x
    torch.cuda.synchronize()
    rec = Profiler()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with rec.span("clock.cuda") as sp:
            x @ x
            torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    assert dev and sp is not None
    for e in dev:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        print(f"{e.name()[:60]}: span start to kernel start {a - sp.start} ns, "
              f"kernel end to span end {sp.end - b} ns")
        assert sp.start <= a <= b <= sp.end
