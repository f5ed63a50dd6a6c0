"""Wrappers of the Hopper kernels in ``csrc/``: the DP (``extd2.cu``,
``extd2_fold.cu``, ``extd2_band.cu`` and their int16 lane-state
counterparts ``extd2_i16.cu``, ``extd2_fold_i16.cu``,
``extd2_band_i16.cu``) and the windowed backtrack
(``backtrack_band.cu``); it builds and binds every ``csrc/`` kernel (the
vote kernels' wrappers are in ``ops/vote.py``).

``extd2_batch`` is the one DP entry point and mirrors
``extd2_batch_pallas``: it takes the tensors of ``ops/dp.py::extd2_batch``.
With ``band_budget`` set and a lane window narrower than round128(Lt)
(``ops/dp_band.py::window_geometry``) it returns what
``ops/dp_band.py::extd2_band`` returns; with ``fold=True`` what
``ops/dp_fold.py::extd2_fold`` returns (the raw folded dirs layout);
otherwise what ``ops/dp.py::extd2_batch`` returns. Its ``state_dtype``
("int32" or "int16") is ``extd2_batch_pallas``'s: with "int16" the lane
state is 16-bit (the ``*_i16.cu`` kernels pack two lanes in each 32-bit
register), exact under ``dp.safe_state_dtype``'s bound, and outside it
raises ``ValueError``. ``backtrack_band`` walks
the dirs of any of the three layouts: the short-read step's (full width or
folded) and the long-read buckets' (banded or full width).

For CUDA tensors each launches its hand-written kernel (built with ``nvcc``
for ``sm_90a`` at first use and bound with ctypes); for CPU tensors it runs
the plain torch version. The int16 window runs each candidate on a
thread-block cluster of the size ``band_cluster_size`` picks in code. There is no fallback from one to the other: a CUDA
call either launches or raises. ``launches``, ``fold_launches``,
``band_launches``, their int16 counterparts ``i16_launches``,
``fold_i16_launches``, ``band_i16_launches``, and ``backtrack_launches``
count kernel launches (a full-width int16 call up to 512 lanes is one or
two: ``i16_full_plan``). On the card the DP returns None for offs and
off_ends: no path reads them, and ``dp.band_geometry`` gives them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from gdiet_tpu_torch.ops import LaunchCount
from gdiet_tpu_torch.ops import dp, dp_band, dp_fold

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
# one shared library per csrc/<name>.cu (the vote kernels' wrappers:
# ops/vote.py); csrc/*.cuh are the headers they share
KERNELS = ("extd2", "extd2_fold", "extd2_band", "extd2_i16", "extd2_fold_i16",
           "extd2_band_i16", "backtrack_band", "vote_scan", "vote_lr")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = LaunchCount()
fold_launches = LaunchCount()
band_launches = LaunchCount()
backtrack_launches = LaunchCount()
i16_launches = LaunchCount()
fold_i16_launches = LaunchCount()
band_i16_launches = LaunchCount()
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA DP "
                           "kernels are built from csrc/ at first use")
    return found


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    # every header counts: a source may include any of them
    deps = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src.read_bytes() + deps + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}_{tag}.so"


def build_all(names=KERNELS, verbose: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` for each name into ``_build/`` (cached by
    source hash), one ``nvcc`` per source, all started together. Returns
    {name: (library path, seconds spent compiling, compiler output)}."""
    out, procs = {}, {}
    for name in names:
        src, so = _target(name)
        if so.exists():
            out[name] = (so, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, so)
    failed = []
    for name, (proc, t0, tmp, so) in procs.items():  # wait for every nvcc
        log, _ = proc.communicate(timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        out[name] = (so, secs, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_HALVES = [_P] * 6 + [_I64]  # fk, fq, fok, rk, rq, rok, their row stride
# each library's C entry points and their arguments
_DP_ARGS = {"extd2": [_P] * 7 + [_I64] * 5 + [_I] * 8 + [_P],
            "extd2_fold": [_P] * 7 + [_I64] * 8 + [_I] * 8 + [_P],
            "extd2_band": [_P] * 7 + [_I64] * 6 + [_I] * 10 + [_P]}
ENTRIES = {
    **{name: {f"gdiet_{name}": args} for name, args in _DP_ARGS.items()},
    **{f"{name}_i16": {f"gdiet_{name}_i16": args} for name, args in _DP_ARGS.items()},
    # the full width: the block route; one launch of the warp route (an
    # entry of i16_full_plan after the scoring); each layout's occupancy
    "extd2_i16": {"gdiet_extd2_i16": _DP_ARGS["extd2"],
                  "gdiet_extd2_i16_warp": _DP_ARGS["extd2"][:-1] + [_I] * 9 + [_P],
                  "gdiet_extd2_i16_resident": [_I64] * 3 + [_P]},
    # the int16 window takes the cluster size after the scoring, and says
    # how many clusters of that size are resident at once
    "extd2_band_i16": {"gdiet_extd2_band_i16": [_P] * 7 + [_I64] * 6 + [_I] * 11 + [_P],
                       "gdiet_extd2_band_i16_max_clusters": [_I64, _I64, _I, _P]},
    "backtrack_band": {"gdiet_backtrack_band": [_P] * 7 + [_I64] * 8 + [_I] * 2 + [_P]},
    "vote_scan": {"gdiet_vote_scan": _HALVES + [_P] * 14 + [_I64] * 2 + [_I] + [_P]},
    "vote_lr": {"gdiet_vote_lr": _HALVES + [_P] * 10 + [_I64] * 2 + [_I] + [_P],
                "gdiet_vote2_pair": _HALVES + [_P] * 7 + [_I64] * 2 + [_P]},
}


def bind(so, name: str) -> ctypes.CDLL:
    """Load a built library and declare its entry points' arguments."""
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = bind(build_all([name])[name][0], name)
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"extd2: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"extd2: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"extd2: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"extd2: {name} is not contiguous")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# the DP libraries and launch counts of each lane-state type
_DP_ROUTES = {"int32": {"extd2": ("extd2", launches),
                        "extd2_fold": ("extd2_fold", fold_launches),
                        "extd2_band": ("extd2_band", band_launches)},
              "int16": {"extd2": ("extd2_i16", i16_launches),
                        "extd2_fold": ("extd2_fold_i16", fold_i16_launches),
                        "extd2_band": ("extd2_band_i16", band_i16_launches)}}


# (round16(Lmax), round16(Lt)) of the full-width calls at which the int16
# kernel measured faster than the int32 one in turns on an H100
# (chip_smoke.py's kernel_int16, PERF.md §6): the warp route at 112 (100 bp
# reads), 128, 160 (the SE width, since csrc/extd2_i16.cu's two rows a
# warp), 192, 256 and 512 lanes, the block route at the LR (512, 1024)
# bucket. Every other shape is unmeasured and keeps int32.
I16_FULL_WIDTH_SHAPES = frozenset({(112, 112), (128, 128), (160, 160), (192, 192), (256, 256),
                                   (512, 512), (512, 1024)})
# the same for the fold (csrc/extd2_fold_i16.cu against csrc/extd2_fold.cu):
# the SE and PE steps' 160-lane calls (6,272 and 5,120 rows), where the int16
# fold with its filler and walker warps measured faster than int32; other
# widths are unmeasured and keep int32.
I16_FOLD_SHAPES = frozenset({(160, 160)})
# csrc/extd2_fold_i16.cu's widest fold: a block of T / 2 compute threads and
# the filler and walker warps holds at most 1,024 threads
FOLD_I16_MAX_LANES = 1920


def route_state_dtype(params, Lmax: int, Lt: int | None = None, fold: bool = False,
                      band_budget: int | None = None,
                      unroll: int = dp_band.DP_UNROLL) -> str:
    """The lane state a path's DP call takes (``extd2_batch``'s
    ``state_dtype`` for the same arguments): int16 where
    ``dp.safe_state_dtype`` allows it and the card measured the int16
    kernel of the call's layout faster, else int32. The banded window:
    int16 (0.75-0.86x at the HiFi buckets at band 500 and the ONT chunk at
    band 1300). The full width: int16 at ``I16_FULL_WIDTH_SHAPES``. The
    fold: int16 at ``I16_FOLD_SHAPES``."""
    if dp.safe_state_dtype(params) != "int16":
        return "int32"
    Lt = Lmax if Lt is None else Lt
    if fold:
        return "int16" if (dp.round16(Lmax), dp.round16(Lt)) in I16_FOLD_SHAPES else "int32"
    if band_budget is not None and dp_band.window_geometry(
            band_budget, dp.round_up(Lt, 128), unroll) is not None:
        return "int16"
    return "int16" if (dp.round16(Lmax), dp.round16(Lt)) in I16_FULL_WIDTH_SHAPES else "int32"


# csrc/extd2_i16.cu's warp route, up to I16_WARP_LANES lanes: its layouts
# (lanes W, threads a row G, slots NS of 2G lanes; the kernel's by_layout
# instances), the narrow layout's lanes, the zero warps an SM (two: one was
# slower at 512 lanes, where zeros are most of the call, four at both
# generic widths), the warps of rows an SM past which a DP warp takes more
# rows than it holds at once, and the warps of rows an SM that a chunked
# launch's last rows take one round a warp (48: the fastest of 0-96 at the
# generic call, PERF.md §6). Above I16_WARP_LANES: the block route.
I16_WARP_LANES = 512
I16_LAYOUTS = ((64, 8, 4), (128, 16, 4), (160, 16, 5), (192, 16, 6), (256, 32, 4),
               (512, 32, 8))
I16_NARROW = 160
I16_ZERO_WARPS_PER_SM = 2
I16_CHUNK_WARPS_PER_SM = 32
I16_TAIL_WARPS_PER_SM = 48
_INT_MAX = 2 ** 31 - 1
# the fields of a plan entry that gdiet_extd2_i16_warp takes, in order
_WARP_ARGS = ("W", "G", "tl_lo", "tl_hi", "chunk", "split", "head_warps", "zero_warps",
              "dp_warps")


def i16_full_plan(N: int, T: int, n_sms: int) -> list:
    """How ``csrc/extd2_i16.cu`` runs a full-width call of N rows of T <=
    ``I16_WARP_LANES`` lanes on ``n_sms`` SMs: one launch per entry, each
    {W, G, NS, tl_lo, tl_hi, chunk, split, head_warps, zero_warps,
    dp_warps}, passed to the kernel as it is (``gdiet_extd2_i16_warp``). A
    launch's DP warps align the rows with tl_lo < round16(tlen) <= tl_hi in
    the narrowest layout of W >= T lanes (G threads a row, thread g's pair
    k the row's pair k G + g: NS slots of 2G lanes, 32 / G rows a warp);
    above ``I16_NARROW`` lanes the rows whose target fits it take the
    narrow layout in a first launch and the others T's own in a second. A
    DP warp takes ``chunk`` rows (its rows a warp times the rounds that
    keep ``I16_CHUNK_WARPS_PER_SM`` warps of rows an SM, at most 32 rows;
    one row where a warp holds one: it pairs no dead row with a live one)
    and aligns their live ones; where a chunk is more than one round, the
    last ``I16_TAIL_WARPS_PER_SM`` warps of rows an SM (from row ``split``
    on, after ``head_warps`` chunks) go one round a warp, so that the
    launch ends on short work. The first launch's leading ``zero_warps``
    (``I16_ZERO_WARPS_PER_SM`` an SM) write the zero wavefronts."""
    if not 0 < T <= I16_WARP_LANES or N <= 0 or n_sms <= 0:
        raise ValueError(f"i16_full_plan: the warp route takes 0 < T <= {I16_WARP_LANES} "
                         f"and N > 0, not T = {T}, N = {N}")
    zero = min(N, I16_ZERO_WARPS_PER_SM * n_sms)

    def launch(T_, lo, hi, z):
        W, G, NS = next(lay for lay in I16_LAYOUTS if lay[0] >= T_)
        rpw = 32 // G
        m = 1 if rpw == 1 else N // (rpw * n_sms * I16_CHUNK_WARPS_PER_SM)
        chunk = rpw * max(1, min(m, 32 // rpw))
        tail_rows = rpw * n_sms * I16_TAIL_WARPS_PER_SM
        split = N - tail_rows if chunk > rpw and N > tail_rows else 0
        head = -(-split // chunk)
        return {"W": W, "G": G, "NS": NS, "tl_lo": lo, "tl_hi": hi, "chunk": chunk,
                "split": split, "head_warps": head, "zero_warps": z,
                "dp_warps": head + -(-(N - split) // rpw)}

    if T > I16_NARROW:
        return [launch(I16_NARROW, 0, I16_NARROW, zero), launch(T, I16_NARROW, _INT_MAX, 0)]
    return [launch(T, 0, _INT_MAX, zero)]


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def i16_plan(N: int, T: int, Lmax: int, dev) -> list:
    """``i16_full_plan`` on ``dev`` (a CUDA device), each launch with its
    layout's resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local bytes a thread and shared bytes a block at Lmax, as the kernel
    reports them; raises on a CUDA error."""
    dev = torch.device(dev)
    n_sms = _sms(dev)
    lib = _library("extd2_i16")
    plan = i16_full_plan(N, T, n_sms)
    for p in plan:
        occ = (ctypes.c_int32 * 4)()
        with torch.cuda.device(dev):
            rc = lib.gdiet_extd2_i16_resident(p["W"], T, Lmax, occ)
        if rc != 0:
            raise RuntimeError(f"extd2_i16: occupancy of the {p['W']}-lane layout failed: "
                               f"CUDA error {rc}")
        p.update(blocks_per_sm=occ[0], registers=occ[1], local_bytes=occ[2],
                 shared_bytes=occ[3], sms=n_sms)
    return plan


# the cluster sizes of csrc/extd2_band_i16.cu, and the fewest lane pairs a
# block of a cluster holds (a window shift moves the state by 64 pairs)
CLUSTER_SIZES = (1, 2, 4, 8)
MIN_CLUSTER_PAIRS = 64


def band_cluster_sizes(WB: int) -> list:
    """The cluster sizes ``csrc/extd2_band_i16.cu`` takes at window width
    WB: those of ``CLUSTER_SIZES`` that split the window's WB / 2 lane
    pairs into blocks of at least ``MIN_CLUSTER_PAIRS`` pairs (C > 1) and
    whole warps of one pair a thread."""
    return [C for C in CLUSTER_SIZES
            if C == 1 or (WB // 2 % (32 * C) == 0 and WB // 2 // C >= MIN_CLUSTER_PAIRS)]


def band_cluster_size(N: int, WB: int, n_sms: int, resident) -> int:
    """The cluster size C the int16 window kernel (``csrc/extd2_band_i16.cu``)
    runs N candidates of window width WB at: the largest C the kernel takes
    there (``band_cluster_sizes``) with all N clusters resident at once,
    one block an SM: N * C <= ``n_sms`` and N <= ``resident(C)``, the
    clusters of C blocks the card holds at once
    (``cudaOccupancyMaxActiveClusters``). A candidate's wavefronts are a
    serial chain, so C blocks a candidate spread one wavefront over C SMs;
    beyond the SMs that are free, clusters would share them. N counts every
    row, live or not (a count of live rows would need a device sync)."""
    best = 1
    for C in band_cluster_sizes(WB)[1:]:
        if N * C <= n_sms and N <= resident(C):
            best = C
    return best


_resident_cache: dict = {}


def _resident(dev, Lmax: int, WB: int, C: int) -> int:
    """cudaOccupancyMaxActiveClusters of the int16 window kernel's launch
    at (Lmax, WB) on clusters of C blocks, on ``dev``; raises on a CUDA
    error."""
    key = (str(dev), Lmax, WB, C)
    if key not in _resident_cache:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _library("extd2_band_i16").gdiet_extd2_band_i16_max_clusters(
                Lmax, WB, C, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"extd2_band_i16: cudaOccupancyMaxActiveClusters at "
                               f"C = {C} failed: CUDA error {rc}")
        _resident_cache[key] = out.value
    return _resident_cache[key]


def band_i16_plan(N: int, Lmax: int, WB: int, dev) -> dict:
    """How ``extd2_batch`` launches the int16 window on ``dev`` (a CUDA
    device) for N candidates: the cluster size ``band_cluster_size`` picks,
    the resident clusters of that size, the SMs, the lane pairs and warps a
    block (the compute warps, the filler and the walker)."""
    dev = torch.device(dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    C = band_cluster_size(N, WB, n_sms, lambda c: _resident(dev, Lmax, WB, c))
    P = WB // 2 // C
    ppt = 1 if P <= 960 else 2 if P <= 1920 else 4  # the kernel's pairs a thread
    return {"cluster": C, "max_active_clusters": _resident(dev, Lmax, WB, C), "sms": n_sms,
            "pairs_per_block": P, "warps_per_block": P // ppt // 32 + 2}


def _run(name: str, count: LaunchCount, dev, entry, *args) -> None:
    """One launch through the C entry point ``entry`` on ``dev``'s current
    stream; raise on a failed launch, count a good one."""
    with torch.cuda.device(dev):
        rc = entry(*args, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count.n += 1


def launch_full_i16(lib, dev, *args) -> None:
    """``csrc/extd2_i16.cu``, built into ``lib``, on ``dev``'s current
    stream; ``args`` are ``gdiet_extd2_i16``'s without the stream (N at 7,
    T at 10). Up to ``I16_WARP_LANES`` lanes the warp route, one launch of
    ``gdiet_extd2_i16_warp`` per entry of ``i16_full_plan``; above, the
    block route. Counts each launch in ``i16_launches``."""
    N, T = args[7], args[10]
    if T > I16_WARP_LANES:
        _run("extd2_i16", i16_launches, dev, lib.gdiet_extd2_i16, *args)
        return
    for p in i16_full_plan(N, T, _sms(dev)):
        _run("extd2_i16", i16_launches, dev, lib.gdiet_extd2_i16_warp, *args,
             *(p[k] for k in _WARP_ARGS))


def _launch(state_dtype: str, layout: str, dev, *args) -> None:
    """Launch the DP kernel of ``layout`` ("extd2", "extd2_fold" or
    "extd2_band") for the lane-state type on ``dev``'s current stream;
    raise on a failed launch, count each good one."""
    name, count = _DP_ROUTES[state_dtype][layout]
    lib = _library(name)
    if name == "extd2_i16":
        launch_full_i16(lib, dev, *args)
    else:
        _run(name, count, dev, getattr(lib, f"gdiet_{name}"), *args)


def extd2_batch(query, target, lens, band, params, Lmax: int, tlens=None,
                Lt: int | None = None, fold: bool = False,
                band_budget: int | None = None, unroll: int = dp_band.DP_UNROLL,
                state_dtype: str = "int32"):
    """Banded dual affine-gap extension of N (query, target) windows.

    query [N, Lmax] u8, target [N, Lt] u8, lens/band/tlens [N] i32 (qlen <=
    Lmax, tlen <= Lt). With the lane window engaged (``band_budget`` set
    and ``window_geometry(band_budget, round128(Lt), unroll)`` not None):
    (score [N] i32, dirs [N, R, WB] u8, offs, off_ends [N, R] i32) as
    ops/dp_band.py returns them. Else ``fold=False``: (score, dirs [N,
    Lmax+Lt-1, round16(Lt)], offs, off_ends) as ops/dp.py returns them;
    ``fold=True``: (score [N], dirs [(C+1)*H, Nrows, T] u8, offs, off_ends
    [N, 2H]) as ops/dp_fold.py returns them. The window and the fold
    exclude each other, as in extd2_batch_pallas. ``state_dtype`` "int16"
    launches the layout's int16 kernel (CPU tensors: the plain version with
    int16 state); outside ``dp.safe_state_dtype``'s bound it raises
    ValueError. On the card offs and off_ends are None: the paths never
    read them, their [N, R] passes would cost as much as a kernel at the
    short-read shapes (XLA drops the unused outputs of the JAX step), and
    ``dp.band_geometry`` gives them to a caller that needs them."""
    if Lt is None:
        Lt = Lmax
    dp.state_dtype_of(params, state_dtype)  # raises outside the bound
    windowed = (band_budget is not None and dp_band.window_geometry(
        band_budget, dp.round_up(Lt, 128), unroll) is not None)
    if windowed and fold:
        raise ValueError("extd2: the banded lane window and the fold exclude each other")
    if query.device.type == "cpu":
        if windowed:
            return dp_band.extd2_band(query, target, lens, band, params, Lmax,
                                      lens if tlens is None else tlens, Lt,
                                      band_budget, unroll, state_dtype)
        plain = dp_fold.extd2_fold if fold else dp.extd2_batch
        return plain(query, target, lens, band, params, Lmax, tlens, Lt, state_dtype)
    if query.device.type != "cuda":
        raise ValueError(f"extd2: unsupported device {query.device}")
    N = query.shape[0]
    dev = query.device
    _check("query", query, torch.uint8, (N, Lmax), dev)
    _check("target", target, torch.uint8, (N, Lt), dev)
    _check("lens", lens, torch.int32, (N,), dev)
    _check("band", band, torch.int32, (N,), dev)
    if tlens is not None:
        _check("tlens", tlens, torch.int32, (N,), dev)
    ptrs = (query.data_ptr(), target.data_ptr(), lens.data_ptr(),
            tlens.data_ptr() if tlens is not None else None, band.data_ptr())
    scoring = dp.derive_scoring(params)
    if windowed:
        return _extd2_band_cuda(query, target, lens, band, params, Lmax,
                                tlens if tlens is not None else lens, Lt, band_budget,
                                unroll, state_dtype)
    if fold:
        H, T, Tn = dp_fold.fold_geometry(Lmax, Lt)
        if state_dtype == "int16" and T > FOLD_I16_MAX_LANES:
            raise ValueError(f"extd2: the int16 fold takes at most {FOLD_I16_MAX_LANES} lanes "
                             f"(Lt <= {FOLD_I16_MAX_LANES - 48}), not {T}")
        _, Nrows, C = dp_fold.fold_split(N, T, state_dtype)
        score = torch.empty(((C + 1) * Nrows,), dtype=torch.int32, device=dev)
        dirs = torch.empty(((C + 1) * H, Nrows, T), dtype=torch.uint8, device=dev)
        _launch(state_dtype, "extd2_fold", dev, *ptrs, score.data_ptr(), dirs.data_ptr(),
                N, Lmax, Lt, T, Tn, H, Nrows, C, *scoring)
        return score[Nrows:][:N], dirs, None, None
    T = dp.round16(Lt)
    R = Lmax + Lt - 1
    score = torch.empty((N,), dtype=torch.int32, device=dev)
    dirs = torch.empty((N, R, T), dtype=torch.uint8, device=dev)
    if N:
        _launch(state_dtype, "extd2", dev, *ptrs, score.data_ptr(), dirs.data_ptr(),
                N, Lmax, Lt, T, R, *scoring)
    return score, dirs, None, None


def _extd2_band_cuda(query, target, lens, band, params, Lmax: int, tlens, Lt: int,
                     band_budget: int, unroll: int, state_dtype: str, cluster: int | None = None):
    """The windowed branch of ``extd2_batch`` on checked CUDA tensors (tlens
    given). The int16 kernel runs on clusters of ``cluster`` blocks, by
    default the size ``band_i16_plan`` picks; a launch the card refuses at
    that size raises, as any failed launch does."""
    N = query.shape[0]
    dev = query.device
    T, R, WB = dp_band.band_shape(Lmax, Lt, band_budget, unroll)
    score = torch.empty((N,), dtype=torch.int32, device=dev)
    dirs = torch.empty((N, R, WB), dtype=torch.uint8, device=dev)
    if N:
        args = (query.data_ptr(), target.data_ptr(), lens.data_ptr(), tlens.data_ptr(),
                band.data_ptr(), score.data_ptr(), dirs.data_ptr(), N, Lmax, Lt, T, R, WB,
                band_budget, unroll, *dp.derive_scoring(params))
        if state_dtype == "int16":
            args += (cluster or band_i16_plan(N, Lmax, WB, dev)["cluster"],)
        _launch(state_dtype, "extd2_band", dev, *args)
    return score, dirs, None, None


def backtrack_band(dirs, lens, tlens, band, Lmax: int, Lt: int,
                   band_budget: int | None = None, unroll: int = dp_band.DP_UNROLL,
                   fold: bool = False):
    """Backtrack of the dirs of one DP call, in its layout: the raw folded
    layout of ``extd2_fold`` ([(C+1)*H, Nrows, T], N taken from ``lens``)
    with ``fold=True``; else the windowed layout of ``extd2_band`` when
    ``band_budget``'s window engages at (Lt, unroll); else the full width
    of ``extd2`` ([N, R, round16(Lt)]). Returns (ops [N, Rpad] u8, fin_i
    [N] i32, fin_j [N] i32) as ``pipeline/device_step.py::backtrack_antidiag``
    does, which is what CPU tensors run; CUDA tensors launch
    ``csrc/backtrack_band.cu``."""
    if dirs.device.type == "cpu":
        from gdiet_tpu_torch.pipeline.device_step import backtrack_antidiag

        return backtrack_antidiag(dirs, lens, band, Lmax, tlens=tlens, Lt=Lt, fold=fold,
                                  band_budget=band_budget, unroll=unroll)
    if dirs.device.type != "cuda":
        raise ValueError(f"backtrack_band: unsupported device {dirs.device}")
    N = lens.shape[0]
    dev = dirs.device
    T = dp.round_up(Lt, 128)  # the band limits' lane range
    WB = None
    if fold:
        if band_budget is not None:
            raise ValueError("backtrack_band: the banded lane window and the fold "
                             "exclude each other")
        H, Wd, _ = dp_fold.fold_geometry(Lmax, Lt)
        # the DP's row split depends on its lane-state type: take it from
        # the dirs (C + 1 passes of H wavefronts, Nrows kernel rows)
        Nrows = dirs.shape[1] if dirs.dim() == 3 else 0
        C = max(1, -(-N // Nrows)) if Nrows else 1
        shape, R = ((C + 1) * H, Nrows, Wd), 2 * H
    else:
        WB = (dp_band.window_geometry(band_budget, T, unroll)
              if band_budget is not None else None)
        if WB is None:
            Wd, R = dp.round16(Lt), Lmax + Lt - 1
        else:
            Wd, R = WB, dp_band.band_shape(Lmax, Lt, band_budget, unroll)[1]
        shape, H, Nrows = (N, R, Wd), R, 1
    _check("dirs", dirs, torch.uint8, shape, dev)
    for name, t in (("lens", lens), ("tlens", tlens), ("band", band)):
        _check(name, t, torch.int32, (N,), dev)
    if dirs.data_ptr() % 16:
        raise ValueError("backtrack_band: dirs must be 16-byte aligned")
    Rpad = dp.round_up(R, 8)
    ops = torch.empty((N, Rpad), dtype=torch.uint8, device=dev)
    fin_i = torch.empty((N,), dtype=torch.int32, device=dev)
    fin_j = torch.empty((N,), dtype=torch.int32, device=dev)
    if N:
        lib = _library("backtrack_band")
        with torch.cuda.device(dev):
            rc = lib.gdiet_backtrack_band(
                dirs.data_ptr(), lens.data_ptr(), tlens.data_ptr(),
                band.data_ptr(), ops.data_ptr(), fin_i.data_ptr(),
                fin_j.data_ptr(), N, R, Wd, T, Rpad, WB or 0, H, Nrows,
                band_budget or 0, unroll, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"backtrack_band kernel launch failed: CUDA error {rc}")
        backtrack_launches.n += 1
    return ops, fin_i, fin_j
