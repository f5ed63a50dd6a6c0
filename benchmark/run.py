"""The benchmark of gdiet_tpu_torch: one cell of ``BENCHMARK.json`` per run.

    python3 -m benchmark.run --workload pacbio_hifi.wgs --seed 7 --seconds 20 --trace 0

A cell names a configuration (``benchmark/configs/<config>.json``: the
published command line and the genome's size) and a traffic mix
(``benchmark/traffic/<mix>.json``, read by ``traffic.py``); a per-layer
metric is ``benchmark/metrics/<metric>.py``. All three are found by name.

Set-up (``setup_s``, from the start of this process): the genome from the
seed; the index on the card with the port's ``index.build_index``; the
port's kernels loaded from its ``_build/`` cache (``nvcc`` runs only in a
checkout's first run); one warm call of the entry on reads of the window's
own lengths: every one within the long-read mapper's device envelope and
the shortest over it; the window's reads written as FASTQ under
``TMPDIR``. Each part is printed on standard error.

The window's work is fixed by the mix: ``window_reads_per_s`` times
``--seconds`` reads, the same lengths for every seed, in one FASTQ. It is
one call of the entry that ``runtime.route`` gives the published command
line, ``runtime.run_generic`` (the long-read mapper inside), on the index
from set-up, writing SAM into a named pipe that this process reads. Every
read's records count; the rate is taken over all reads and the call's
whole wall time.

After the window the peak device memory is read, the program's state is
freed, and the plain reference (``benchmark/reference``: a frozen copy of
the scalar oracle and of its C routines, and the index worked out again in
NumPy) decides ``correct``: the index entry for entry, and every SAM
record of every window read within the device envelope and of a sample of
the others drawn from the seed, besides every read having its records.
The reference maps the compared reads on a pool of threads that share its
index; the log line ``reference: ...`` gives its time, its ms/kbp and the
process's wall time so far.
``--control 1`` runs the control instead of the program: the reference
with its index keys cut to 32 bits and its DP's lanes and score
saturating at int8, put in the program's place.

``--trace 1`` adds the per-layer metrics: CUDA events at the long-read
mapper's phase marks, host clocks around its host tail, its counters, and
a torch.profiler trace of the device over the window.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gdiet_tpu")
REF_WORKERS = 8  # the reference's workers: index processes, check threads


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    """Top-level module names, compared whole, of JAX and the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The end-to-end (``kind`` "end_to_end") or per-layer metrics that
    ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((cell in m["workloads"]) if "workloads" in m else m["moves"] in names)]


# ---------------------------------------------------------------------------
# the program's side
# ---------------------------------------------------------------------------
def program_options(args: list, device: str):
    """The published command line read by the port's own CLI (its
    ``run_mapping`` replaced by a recorder): (io, mo, variant, n_threads,
    cli_line)."""
    from gdiet_tpu_torch import cli, runtime

    seen = {}

    def record(io, mo, variant, **kw):
        seen.update(io=io, mo=mo, variant=variant, **kw)
        return 0

    orig = runtime.run_mapping
    runtime.run_mapping = record
    try:
        cli.main([*args, "--device", device, "genome.fa", "reads.fq"])
    finally:
        runtime.run_mapping = orig
    return seen["io"], seen["mo"], seen["variant"], seen["n_threads"], seen["cli_line"]


class SamPipe:
    """A named pipe the entry writes SAM into; a thread reads it whole."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        os.mkfifo(path)
        self.chunks: list = []
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        with open(self.path, "rb", buffering=0) as f:
            while True:
                b = f.read(1 << 22)
                if not b:
                    return
                self.chunks.append(b)

    def close(self) -> bytes:
        if self.thread.is_alive():
            self.thread.join(timeout=5)
        if self.thread.is_alive():  # the writer never opened it
            with open(self.path, "wb"):
                pass
            self.thread.join()
        return b"".join(self.chunks)


def call_entry(mi, mo, variant, n_threads, cli_line, device, query, out):
    from gdiet_tpu_torch import runtime

    return runtime.run_generic(mi, mo, variant, [str(query)], str(out), n_threads, 1,
                               cli_line, time.perf_counter(), device)


def lr_envelope() -> int:
    """The longest read the long-read mapper maps on the device, as the
    runtime builds it (its default ``max_read_len``); longer reads take
    the scalar oracle."""
    import inspect

    from gdiet_tpu_torch.pipeline.longread import LongReadMapper

    return inspect.signature(LongReadMapper).parameters["max_read_len"].default


def parse_sam(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(read id, line start, line end) of every record line; read names
    are r<9 digits>."""
    a = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(a == 10)
    starts = np.concatenate([[0], nl[:-1] + 1]) if len(nl) else np.zeros(0, np.int64)
    rec = a[starts] != ord("@") if len(starts) else np.zeros(0, bool)
    starts, ends = starts[rec], nl[rec]
    ok = (ends - starts > 10) & (a[np.minimum(starts, len(a) - 1)] == ord("r"))
    ids = np.full(len(starts), -1, np.int64)
    if ok.any():
        d = a[starts[ok][:, None] + 1 + np.arange(9)].astype(np.int64) - 48
        good = ((d >= 0) & (d <= 9)).all(1) & (a[starts[ok] + 10] == 9)
        val = d @ (10 ** np.arange(8, -1, -1, dtype=np.int64))
        ids[np.flatnonzero(ok)] = np.where(good, val, -1)
    return ids, starts, ends


class Tracer:
    """The traced run's hooks: installed around the window, removed after."""

    DP_RANGES = ("bench::extd2_batch", "bench::backtrack_band")

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"
        self.lr_batches: list = []  # [(mark, event)] per long-read batch
        self.host_tail_ms: list = []
        self.dp_rows: list = []  # (qlens, tlens, band, fin_i, fin_j) per call
        self.patches: list = []
        self.prof = None

    def event(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def span_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def _patch(self, obj, name, new):
        self.patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def install(self):
        from gdiet_tpu_torch.ops import extd2
        from gdiet_tpu_torch.pipeline import longread
        from torch.profiler import record_function

        tr = self
        start_batch = longread.LongReadMapper._start_batch
        tail_batch = longread.LongReadMapper._tail_batch

        def start(m, reads):
            marks = [("start", tr.event())]
            m.mark = lambda n: marks.append((n, tr.event()))
            tr.lr_batches.append(marks)
            return start_batch(m, reads)

        def tail(m, st):
            t = time.perf_counter()
            out = tail_batch(m, st)
            tr.host_tail_ms.append((time.perf_counter() - t) * 1e3)
            return out

        dp_batch, backtrack = extd2.extd2_batch, extd2.backtrack_band

        def dp(*a, **kw):
            with record_function(tr.DP_RANGES[0]):
                return dp_batch(*a, **kw)

        def bt(dirs, lens, tlens, band, *a, **kw):
            with record_function(tr.DP_RANGES[1]):
                out = backtrack(dirs, lens, tlens, band, *a, **kw)
            tr.dp_rows.append((lens, tlens, band, out[1], out[2]))
            return out

        self._patch(longread.LongReadMapper, "_start_batch", start)
        self._patch(longread.LongReadMapper, "_tail_batch", tail)
        self._patch(extd2, "extd2_batch", dp)
        self._patch(extd2, "backtrack_band", bt)
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()

    def remove(self):
        if self.prof is not None:
            self.torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
        for obj, name, orig in reversed(self.patches):
            setattr(obj, name, orig)
        self.patches = []

    def device_events(self) -> list:
        """(name, start us, end us) of every device operation traced."""
        if self.prof is None:
            return []
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            # the DP ranges show on the device's timeline too, over their kernels
            if e.device_type() != DeviceType.CUDA or e.name() in self.DP_RANGES:
                continue
            st = e.start_ns() / 1e3 if hasattr(e, "start_ns") else float(e.start_us())
            du = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else float(e.duration_us())
            out.append((e.name(), st, st + du))
        return out

    def dp_device_s(self):
        """Device seconds of every kernel launched inside the DP and
        backtrack calls' ranges; None without a trace of one."""
        if self.prof is None:
            return None
        us = sum(e.device_time_total for e in self.prof.events() if e.name in self.DP_RANGES)
        return us / 1e6 if us > 0 else None


def stats_of(mappers: list) -> dict:
    out: dict = {}
    for m in mappers:
        for k, v in m.stats.items():
            out[k] = out.get(k, 0) + int(v)
    return out


def card_facts() -> dict:
    """Name, SMs, maximum SM clock and power limit of card 0."""
    import torch

    p = torch.cuda.get_device_properties(0)
    facts = {"name": torch.cuda.get_device_name(0), "sms": p.multi_processor_count}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30).stdout
        clk, pw = q.strip().splitlines()[0].split(",")
        facts["max_sm_clock_mhz"] = float(clk)
        facts["power_limit_w"] = float(pw)
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return facts


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        e2e: list, per_layer: list, device: str = "cuda", control: bool = False) -> dict:
    import torch

    from benchmark import genome, traffic

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    setup = {}
    t = time.perf_counter()
    seqs = genome.make_genome(cfg, seed)
    setup["genome_s"] = time.perf_counter() - t
    tr = traffic.Traffic(mix, seqs, seed)
    setup["donor_s"] = time.perf_counter() - t - setup["genome_s"]
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gdiet_bench_"))
    try:
        if control:
            return run_control(cfg, mix, seqs, tr, seed, seconds)
        return run_program(cfg, mix, seqs, tr, seed, seconds, trace, e2e, per_layer,
                           dev, cuda, sync, setup, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def window_size(mix: dict, seconds: float) -> int:
    return max(1, round(float(mix["window_reads_per_s"]) * seconds))


def run_program(cfg, mix, seqs, tr, seed, seconds, trace, e2e, per_layer,
                dev, cuda, sync, setup, tmp):
    import torch

    from benchmark import traffic
    from gdiet_tpu_torch import runtime
    from gdiet_tpu_torch.index.build import build_index
    from gdiet_tpu_torch.pipeline import longread

    io, mo, variant, n_threads, cli_line = program_options(cfg["args"], dev.type)
    route = runtime.route(mo, variant, ["reads.fq"])
    if route != cfg["route"]:
        raise SystemExit(f"the command line routes to {route}, the config says {cfg['route']}")

    t = time.perf_counter()
    mi = build_index(seqs, io, dev)
    sync()
    setup["index_build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if cuda:
        from gdiet_tpu_torch.ops import extd2

        extd2.build_all()
        for name in extd2.KERNELS:
            extd2._library(name)
    setup["kernel_load_s"] = time.perf_counter() - t

    lmax = lr_envelope()
    n_win = window_size(mix, seconds)
    mappers: list = []
    init = longread.LongReadMapper.__init__

    def rec_init(self, *a, **kw):
        init(self, *a, **kw)
        mappers.append(self)

    longread.LongReadMapper.__init__ = rec_init
    try:
        # one warm call on reads of the window's own lengths: every one the
        # device maps and the shortest that the oracle maps; the window's
        # work is fixed, the mix's nominal rate times --seconds
        t = time.perf_counter()
        q = tmp / "warm.fq"
        q.write_bytes(traffic.fastq(tr.reads(n_win, 3, max_len=lmax)))
        call_entry(mi, mo, variant, n_threads, cli_line, dev, q, os.devnull)
        sync()
        q.unlink()
        setup["warm_s"] = time.perf_counter() - t
        t = time.perf_counter()
        reads = tr.reads(n_win, 5)
        query = tmp / "window.fq"
        query.write_bytes(traffic.fastq(reads))
        setup["window_reads"] = n_win
        setup["window_reads_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - _T0
        for k, v in setup.items():
            log(f"setup {k} {v}")
        log(f"setup setup_s {setup_s}")

        del mappers[:]
        tracer = Tracer(dev) if trace else None
        try:
            if tracer:
                tracer.install()
            t, cpu = time.perf_counter(), os.times()
            pipe = SamPipe(tmp / "out.sam")
            try:
                call_entry(mi, mo, variant, n_threads, cli_line, dev, query, pipe.path)
                sync()
            finally:
                sam = pipe.close()
            window_s = time.perf_counter() - t
            cpu = [b - a for a, b in zip(cpu[:2], os.times()[:2])]
        finally:
            if tracer:
                tracer.remove()
    finally:
        longread.LongReadMapper.__init__ = init
    query.unlink()
    log(f"window {window_s} s, {n_win} reads, {len(sam)} bytes of SAM; this process's "
        f"CPU: {cpu[0]} s user, {cpu[1]} s system")

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ids, starts, ends = parse_sam(sam)
    lens = np.array([len(r) for r in reads])
    seen = np.zeros(n_win, bool)
    inside = (ids >= 0) & (ids < n_win)
    seen[ids[inside]] = True
    done = int(seen.sum())
    values = {"lr_mbp_per_s": float(lens[seen].sum()) / 1e6 / window_s, "setup_s": setup_s}
    result = {"correct": None, "attempted": n_win, "failed": int(n_win - done)}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = trace_context(tracer, mappers, window_s, setup, cuda)
        metrics = {}
        for m in per_layer:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = ctx["busy_s"]
        device_info["window_s"] = window_s
        result["breakdown"] = ctx["breakdown"]
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    log("read lengths " + json.dumps(length_hist(lmax, lens)
                                     | {"oracle_reads": stats_of(mappers).get("fallback_reads")}))
    result["metrics"] = metrics
    result["device"] = device_info

    # the program's state goes before the reference runs
    prog_index = (mi.keys, mi.starts, mi.positions, mi.codes)
    mi._dev.clear()
    del mappers[:]
    if tracer is not None:
        tracer.dp_rows = tracer.prof = None
    if cuda:
        torch.cuda.empty_cache()

    checks = check(cfg, mix, seqs, reads, ids, starts, ends, sam, seed, prog_index, lmax)
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def length_hist(lmax: int, lens) -> dict:
    """Counts of the window's reads by length: those within the long-read
    mapper's device envelope (``max_read_len``) and those over it, which
    take the scalar oracle."""
    edges = [0, 2000, 4000, 6000, 8193, 10000, 15000, 20000, 25000, 30001]
    h_all = np.histogram(lens, edges)[0].tolist()
    h_host = np.histogram(lens[lens > lmax], edges)[0].tolist()
    return {"edges": edges, "all": h_all, "over_envelope": h_host,
            "device": [a - b for a, b in zip(h_all, h_host)]}


def trace_context(tracer, mappers, window_s, setup, cuda) -> dict:
    """What the per-layer readers read."""
    lr = []
    for marks in tracer.lr_batches:
        d = {}
        for n, ev in marks[1:]:
            d.setdefault(n, tracer.span_ms(marks[0][1], ev))
        lr.append(d)
    events = tracer.device_events()
    busy_s, gaps = busy_and_gaps(events)
    if events:  # the window's idle time before its first and after its last device operation
        span = (max(e[2] for e in events) - min(e[1] for e in events)) / 1e6
        gaps = sorted(gaps + [("before the first or after the last device operation",
                               window_s - span)], key=lambda g: -g[1])[:10]
    by_name: dict = {}
    for n, a, b in events:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    dp_rows = [tuple(x.cpu().numpy() if x is not None else None for x in row)
               for row in tracer.dp_rows]
    return {
        "window_s": window_s, "setup": setup, "stats": stats_of(mappers),
        "lr_batches": lr, "host_tail_ms": tracer.host_tail_ms, "events": events,
        "busy_s": busy_s, "dp_rows": dp_rows, "dp_device_s": tracer.dp_device_s(),
        "card": card_facts() if cuda else None,
        "breakdown": {"device_ops": [[n[:120], s] for n, s in top],
                      "idle_gaps": [[n[:120], s] for n, s in gaps]},
    }


def busy_and_gaps(events) -> tuple:
    """Seconds in which some device operation ran, and the ten longest gaps
    between them (named by the operation before the gap)."""
    if not events:
        return 0.0, []
    ev = sorted(events, key=lambda e: e[1])
    busy = 0.0
    gaps = []
    cur_a, cur_b, cur_n = ev[0][1], ev[0][2], ev[0][0]
    for n, a, b in ev[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((f"after {cur_n}", (a - cur_b) / 1e6))
            cur_a, cur_b, cur_n = a, b, n
        elif b > cur_b:
            cur_b, cur_n = b, n
    busy += cur_b - cur_a
    gaps.sort(key=lambda g: -g[1])
    return busy / 1e6, gaps[:10]


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------
def reference_lines(ref, mo, mid_occ, name: str, seq: str) -> list:
    """The reference's SAM lines of one read."""
    from benchmark.reference import config as rcfg, sam as rsam
    from benchmark.reference.longread import map_read_lr

    qual = "I" * len(seq)
    regs = map_read_lr(ref, seq, mo, mid_occ, name)
    if not regs:
        return [rsam.sam_record(name, seq, qual, None, [], ref.names, mo.flag, 0)]
    no2 = mo.flag & rcfg.MM_F_NO_PRINT_2ND
    return [rsam.sam_record(name, seq, qual, r, regs, ref.names, mo.flag, 0, index=ref)
            for r in regs if not (no2 and r.id != r.parent)]


def check_threads() -> int:
    return min(REF_WORKERS, os.cpu_count() or 1)


def reference_map(ref, mo, mid_occ, reads, pick) -> list:
    """The reference's SAM lines of each read in ``pick``, in ``pick``'s
    order, mapped on ``check_threads()`` threads, the longest read first.
    The threads share ``ref``, and the C routines that take most of a
    read's time release the interpreter lock."""
    from concurrent.futures import ThreadPoolExecutor

    from benchmark import traffic

    def one(i):
        return reference_lines(ref, mo, mid_occ, traffic.name(i), traffic.seq(reads[i]))

    order = sorted(pick, key=lambda i: -len(reads[i]))
    with ThreadPoolExecutor(check_threads()) as ex:
        done = dict(zip(order, ex.map(one, order)))
    return [done[i] for i in pick]


def sample_ids(mix: dict, seed: int, lens: np.ndarray, lmax: int) -> np.ndarray:
    """The window reads the check compares: every one within the device
    envelope, and ``check_reads`` of the others drawn from the seed."""
    from benchmark import traffic

    over = np.flatnonzero(lens > lmax)
    pick = traffic.rng(seed, 7).choice(over, min(int(mix["check_reads"]), len(over)),
                                      replace=False)
    return np.sort(np.concatenate([np.flatnonzero(lens <= lmax), pick]))


def check(cfg, mix, seqs, reads, ids, starts, ends, sam, seed, prog_index, lmax,
          sample_only: bool = False) -> dict:
    """The numbers compared, each with its limit."""
    from benchmark.reference import options as ropt
    from benchmark.reference.refindex import RefIndex, entry_diff

    t = time.perf_counter()
    io, mo, _, _ = ropt.parse(cfg["args"])
    ref = RefIndex(seqs, io.w, io.k, io.pattern, workers=REF_WORKERS)
    keys, st, pos, codes = prog_index
    genome_codes = np.concatenate([c for _, c in seqs])
    index_diff = entry_diff(keys, st, pos, ref.keys, ref.starts, ref.positions)
    index_diff += int(len(codes) != len(genome_codes)) or int((codes != genome_codes).sum())
    t_index = time.perf_counter() - t

    mid = ref.mid_occ(mo)
    n_win = len(reads)
    lens = np.array([len(r) for r in reads])
    pick = sample_ids(mix, seed, lens, lmax)
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    wrong = 0
    t_map = time.perf_counter()
    lines = reference_map(ref, mo, mid, reads, pick)
    t_map = time.perf_counter() - t_map
    for i, want in zip(pick, lines):
        lo, hi = np.searchsorted(sid, [i, i + 1])
        got = [sam[starts[j]:ends[j]].decode() for j in order[lo:hi]]
        if got != want:
            wrong += 1
            if wrong <= 3:
                log(f"read {i} differs:\n  program   {got}\n  reference {want}")
    seen = np.zeros(n_win, bool)
    inside = (ids >= 0) & (ids < n_win)
    seen[ids[inside]] = True
    # a read of the window with no record, or a record of no read
    no_record = 0 if sample_only else int((~seen).sum()) + int((~inside).sum())
    t_reads = time.perf_counter() - t - t_index
    log(f"reference: index {t_index} s, {len(pick)} reads ({int((lens[pick] <= lmax).sum())} "
        f"within the device envelope) {t_reads} s; mapped in {t_map} s on {check_threads()} "
        f"threads, {t_map / max(lens[pick].sum(), 1) * 1e6} ms/kbp; "
        f"the process's wall time {time.perf_counter() - _T0} s")
    lim = cfg["limits"]
    return {"index_diff": {"value": int(index_diff), "limit": lim["index_diff"]},
            "wrong_reads": {"value": int(wrong + no_record), "limit": lim["wrong_reads"]}}


def run_control(cfg, mix, seqs, tr, seed, seconds) -> dict:
    """The control in the program's place: the reference with 32-bit index
    keys and int8 DP state, judged by the same numbers as a run."""
    from benchmark.reference import native as rnative, options as ropt
    from benchmark.reference.refindex import RefIndex

    io, mo, _, _ = ropt.parse(cfg["args"])
    ctl = RefIndex(seqs, io.w, io.k, io.pattern, key_bits=32, workers=REF_WORKERS)
    reads = tr.reads(window_size(mix, seconds), 5)
    lmax = lr_envelope()
    pick = sample_ids(mix, seed, np.array([len(r) for r in reads]), lmax)
    rnative.set_saturation(127)  # the C library's one setting: every thread reads it
    try:
        lines = [x for ls in reference_map(ctl, mo, ctl.mid_occ(mo), reads, pick) for x in ls]
    finally:
        rnative.set_saturation(0)
    sam = ("\n".join(lines) + "\n").encode()
    ids, starts, ends = parse_sam(sam)
    checks = check(cfg, mix, seqs, reads, ids, starts, ends, sam, seed,
                   (ctl.keys, ctl.starts, ctl.positions, np.concatenate([c for _, c in seqs])),
                   lmax, sample_only=True)
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": len(pick), "failed": 0, "metrics": {}, "device": {},
            "checks": checks}


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1))
    a = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if a.workload not in cells:
        log(f"no workload {a.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[a.workload]
    cfg = load_json(BENCH / "configs" / f"{cell['config']}.json")
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    build = BENCH / "_build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    import torch

    if not a.control and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell["chips"]):
        log(f"{a.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = run(cfg, mix, a.seed, a.seconds, bool(a.trace),
              cell_metrics(bench, a.workload, "end_to_end"),
              cell_metrics(bench, a.workload, "per_layer"),
              device="cuda", control=bool(a.control))
    bad = loaded_forbidden()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}")
        return 3
    checks = res.pop("checks")
    res["checks"] = checks
    for k, c in checks.items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
