#!/usr/bin/env python3
"""Ablations of csrc/extd2_band_i16.cu, csrc/extd2_i16.cu, csrc/vote_lr.cu
and csrc/extd2_fold_i16.cu on the card, timed in turns.

    python3 band_ablation.py [--prev DIR] [--shapes hifi128_2048,se160,...]

Needs one CUDA GPU and nvcc. Builds the checkout's
``gdiet_tpu_torch/csrc/extd2_band_i16.cu`` and variants of it made by
textual edits of that source, each by its own ``nvcc``, and runs each on
seeded long-read windows (``chip_smoke.band_windows``) at the long-read
paths' shapes, at the cluster size ``ops/extd2.py::band_cluster_size``
picks there:

- ``source``: the checkout's kernel (through ``extd2_batch``);
- ``no_walk``: the walker warp does not walk and no tap is stored: what the
  H0 walk costs on top of the DP (its scores are not the kernel's; its dirs
  are, and are checked);
- ``old_query``: the substitution scores from two bounds-checked byte
  loads and compares a pair, as the kernel's one-block predecessor read
  them, instead of one 16-bit load of the reversed query and masks (exact);
- ``earlier`` (``--prev DIR`` with an earlier ``extd2_band_i16.cu`` whose
  entry point takes no cluster size): that source (exact).

Each is exact against the int32 kernel (``csrc/extd2_band.cu``) where its
function is the kernel's, and timed in turns (the list up, then down; each
the median of 5 rounds of launches, CUDA events). Prints one JSON line per
shape and the card's ``nvidia-smi`` name and power limit.

The full-width shapes (``se160``: the SE step's 6,272 rows of 150 bp at
160 lanes; ``gen256``: the generic step's 65,536 rows at 256 lanes,
36,573 of them live; ``gen512``: 8,192 rows at 512 lanes, where zero
wavefronts are most of the bytes) take ``csrc/extd2_i16.cu`` (``chip_smoke.dp_pairs``
rows) and its variants, each the kernel alone (the launches of
``ops/extd2.py::i16_full_plan`` on preallocated outputs,
``extd2.launch_full_i16``), in turns:

- ``source``: the checkout's kernel (score and dirs exact against int32);
- ``no_dirs``: no direction byte stored (the compiler then leaves out
  their computation too; scores exact);
- ``no_walk``: no H0 taps or walk (dirs exact);
- ``zero_only``: the zero warps alone, no DP warp (what the zero
  wavefronts and dead rows cost by themselves);
- ``tail0``, ``tail16``, ``tail96``: the source with the plan's one-round
  tail of a chunked launch (``extd2.I16_TAIL_WARPS_PER_SM``) at 0, 16 and
  96 warps of rows an SM instead of 48 (exact);
- ``zero1``: the source with one zero warp an SM
  (``extd2.I16_ZERO_WARPS_PER_SM``) instead of two (exact).

The long-read vote shapes (``vote_hifi``: 256 reads of 512 columns a half,
20-170 valid, K = 5, vt_distance 650; ``vote_ont``: 16 reads of 4,096, 100-
600 valid, K = 3, vt_distance 1000; seeded streams whose runs are ~120
columns long, as the fronts' are, ``vote_streams``) take
``csrc/vote_lr.cu`` and its variants, both entry points on preallocated
outputs, exact against the source, timed by device time (torch.profiler)
in turns:

- ``steps1``, ``steps8``: one and eight steps of 32 columns in flight a
  warp instead of four;
- ``one_warp``: round 1 by one warp a read walking both halves in turn
  (the kernel's route for K > 32) instead of a warp a half.

The fold shapes (``fold_pe``: the PE step's 5,120 rows; ``fold_se``: the SE
call's 6,272; 160 lanes, ``chip_smoke.dp_pairs`` rows) take
``csrc/extd2_fold_i16.cu`` and its variants through ``extd2_batch``, in
turns with ``csrc/extd2_fold.cu`` (int32):

- ``no_walk``: the walker warp walks no H0 (dirs exact);
- ``no_taps``: no walk and no tap stored by the compute threads (dirs
  exact).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

sys.modules.setdefault("jax", None)  # the port must not need JAX

ROOT = pathlib.Path(__file__).resolve().parent
ONT_PARAMS = (2, 4, 4, 2, 24, 1)  # the map-ont preset's scoring
# name: (rows, Lmax, Lt, band budget, scoring, live rows)
SHAPES = {
    "hifi128_2048": (128, 2048, 3072, 500, "hifi", 123),
    "hifi64_4096": (64, 4096, 5120, 500, "hifi", 62),
    "ont32": (32, 32768, 34048, 1300, "ont", 19),
}
# the full width: name: (rows, lanes, live rows)
FULL_SHAPES = {"se160": (6272, 160, None), "gen256": (65536, 256, 36573),
               "gen512": (8192, 512, None)}
# the textual edits of each variant: (what is replaced, what replaces it)
OLD_QUERY = """      {
        const int i0 = r + 1 - lane0, i1 = i0 - 1;
        const int q0 = (i0 >= 0 && i0 < qlen) ? ((qe16[i0 + kQPad] & 0xff) ^ 4) : 0;
        const int q1 = (i1 >= 0 && i1 < qlen) ? ((qe16[i1 + kQPad] & 0xff) ^ 4) : 0;
        const int t0 = (tcode[k] & 0xff) ^ 4, t1 = ((tcode[k] >> 16) & 0xff) ^ 4;
        const int s0 = (t0 == 4 || q0 == 4) ? -sc.e2 : (t0 == q0 ? sc.a : -sc.b);
        const int s1 = (t1 == 4 || q1 == 4) ? -sc.e2 : (t1 == q1 ? sc.a : -sc.b);
        sv[k] = pack2(s0, s1);
      }"""
VARIANTS = {
    "no_walk": [("      if (walks && e > 0) {", "      if (false) {"),
                ("      if (r_end > 0) walk(b_prev, b);", "      if (false) walk(b_prev, b);"),
                ("        if (d < (unsigned)kTaps) {", "        if (false) {")],
    "old_query": [("""      sv[k] = subst_pair(qe16[__vimin_s32_relu(r + 1 - lane0 + kQPad, qhi)], tcode[k], tn[k],
                         sa, sb, se2);""", OLD_QUERY)],
}


FULL_VARIANTS = {
    "no_dirs": [("      if (row_live && lane0 < g.T) *reinterpret_cast<uint16_t*>(drow + lane0) = (uint16_t)d;",
                 "      if (r == 0x7fffffff && row_live && lane0 < g.T)\n"
                 "        *reinterpret_cast<uint16_t*>(drow + lane0) = (uint16_t)d;")],
    "no_walk": [("    taps();\n", ""), ("    walk(r - 1);\n", ""),
                ("  taps();  // the last wavefront\n", ""), ("  walk(r_max - 1);\n", "")],
    "zero_only": [("  if (c0 >= g.N) return;\n", "  return;\n")],
}
VOTE_SHAPES = {"vote_hifi": (256, 512, 20, 170, 5, 650), "vote_ont": (16, 4096, 100, 600, 3, 1000)}
VOTE_VARIANTS = {
    "steps1": [("constexpr int kSteps = 4;", "constexpr int kSteps = 1;")],
    "steps8": [("constexpr int kSteps = 4;", "constexpr int kSteps = 8;")],
    "one_warp": [("  if (K <= kMaxSmemSlots)\n    vote_lr_kernel",
                  "  if (false)\n    vote_lr_kernel")],
}
FOLD_SHAPES = {"fold_pe": 5120, "fold_se": 6272}
_NO_WALK = ("    auto walk = [&](int p, int r) {\n",
            "    auto walk = [&](int p, int r) {\n      if (p >= 0) return;\n")
FOLD_VARIANTS = {
    "no_walk": [_NO_WALK],
    "no_taps": [_NO_WALK, ("      taps[(g & 1) * NP + j] = make_uint2(v, u);", "")],
}
# the source under other plans: the one-round tail of a chunked launch at
# none, 16 and 96 warps of rows an SM against 48; one zero warp an SM
# against two
FULL_PLANS = {**{f"tail{n}": {"I16_TAIL_WARPS_PER_SM": n} for n in (0, 16, 96)},
              "zero1": {"I16_ZERO_WARPS_PER_SM": 1}}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"band_ablation: the source no longer has {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(name: str, src: pathlib.Path, out_dir: pathlib.Path):
    from gdiet_tpu_torch.ops import extd2

    so = out_dir / f"{name}.so"
    proc = subprocess.Popen([extd2._nvcc(), *extd2.NVCC_FLAGS, "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, proc, so


def full_ablation(shapes, cs, out_dir) -> None:
    """The full-width shapes: ``csrc/extd2_i16.cu``, FULL_VARIANTS and
    FULL_PLANS, each the kernel alone, in turns; exact where the variant
    keeps the output."""
    import numpy as np
    import torch

    from gdiet_tpu_torch.ops import dp, extd2

    source = (extd2.CSRC / "extd2_i16.cu").read_text()
    procs = []
    for name, edits in FULL_VARIANTS.items():
        path = out_dir / f"full_{name}.cu"
        path.write_text(variant_source(source, edits))
        procs.append(build(f"full_{name}", path, out_dir))
    libs = {"source": extd2._library("extd2_i16")}
    for name, proc, so in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        libs[name[len("full_"):]] = extd2.bind(so, "extd2_i16")
    for shape in shapes:
        N, L, live = FULL_SHAPES[shape]
        Q, T, lens, band = cs.dp_pairs(N, L, 150)
        if live is not None:  # dead rows spread over the batch, as the step's are
            lens[np.random.default_rng(7).choice(N, N - live, replace=False)] = 0
        q, t, ln, bd = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band))
        R = 2 * L - 1
        ref = extd2.extd2_batch(q, t, ln, bd, cs.PARAMS, L)
        score = torch.empty((N,), dtype=torch.int32, device=q.device)
        dirs = torch.empty((N, R, L), dtype=torch.uint8, device=q.device)

        def alone(lib, consts=None):
            def run():
                saved = {k: getattr(extd2, k) for k in consts or {}}
                for k, v in (consts or {}).items():
                    setattr(extd2, k, v)
                try:
                    extd2.launch_full_i16(lib, q.device, q.data_ptr(), t.data_ptr(),
                                          ln.data_ptr(), None, bd.data_ptr(), score.data_ptr(),
                                          dirs.data_ptr(), N, L, L, L, R,
                                          *dp.derive_scoring(cs.PARAMS))
                finally:
                    for k, v in saved.items():
                        setattr(extd2, k, v)
            return run

        fns = {name: alone(lib) for name, lib in libs.items()}
        fns.update({name: alone(libs["source"], consts) for name, consts in FULL_PLANS.items()})
        exact = {}
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            exact[name] = {"score": bool(torch.equal(score, ref[0])),
                           "dirs": bool(torch.equal(dirs, ref[1]))}
        want = {"source": ("score", "dirs"), "no_dirs": ("score",), "no_walk": ("dirs",),
                "zero_only": (), "zero1": ("score", "dirs"),
                **{f"tail{n}": ("score", "dirs") for n in (0, 16, 96)}}
        for name, keys in want.items():
            if not all(exact[name][k] for k in keys):
                raise SystemExit(f"band_ablation: {name} differs from the int32 kernel on {shape}")
        names = list(fns)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cs.rounds_ms(fns[name]))
        print(json.dumps({"shape": shape, "rows": N, "live_rows": int((lens > 0).sum()),
                          "lanes": L, "kernel": "extd2_i16",
                          "ms": {k: float(np.mean(v)) for k, v in turns.items()},
                          "turns_ms": turns, "exact": exact}), flush=True)
        del ref, score, dirs


def vote_streams(B: int, A: int, nmin: int, nmax: int, dist: int, seed: int = 7) -> dict:
    """Seeded long-read vote streams laid out as the front lays them out
    (fwd | barrier | rev | barrier, valid-first halves of nmin-nmax valid
    columns), in runs of ~120 columns (geometric) whose keys step by 0-5,
    the runs far apart; query positions over a 30 kb read."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M = 2 * (A + 1)
    keys = np.full((B, M), np.uint64(2**64 - 1), np.uint64)
    qpos = np.zeros((B, M), np.int32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        for h in range(2):
            n, off = int(rng.integers(nmin, nmax + 1)), h * (A + 1)
            pos, c = int(rng.integers(0, 1 << 30)), 0
            while c < n:
                L = min(n - c, int(rng.geometric(1 / 120)))
                keys[b, off + c:off + c + L] = np.uint64(pos) + np.cumsum(
                    rng.integers(0, 6, L)).astype(np.uint64)
                q = np.sort(rng.integers(0, 30000, L))
                qpos[b, off + c:off + c + L] = q if h else q[::-1]
                valid[b, off + c:off + c + L] = True
                c += L
                pos += int(rng.integers(5000, 50000))
    return {"keys": keys, "qpos": qpos, "valid": valid,
            "extracted": rng.integers(1000, 30000, B).astype(np.int64),
            "vt_distance": np.full(B, dist, np.int64), "cov_thr": np.full(B, 20, np.int32),
            "lo1": np.zeros(B, np.int32), "hi1": rng.integers(0, 3000, B).astype(np.int32),
            "lo2": rng.integers(20000, 29000, B).astype(np.int32),
            "hi2": np.full(B, 30000, np.int32)}


def vote_ablation(shapes, cs, out_dir) -> None:
    """The vote shapes: ``csrc/vote_lr.cu`` and VOTE_VARIANTS, both entry
    points on preallocated outputs, exact against the source (which
    chip_smoke.py holds against the plain loops), device time in turns."""
    import numpy as np
    import torch

    from gdiet_tpu_torch.ops import extd2, vote

    source = (extd2.CSRC / "vote_lr.cu").read_text()
    procs = []
    for name, edits in VOTE_VARIANTS.items():
        path = out_dir / f"vote_{name}.cu"
        path.write_text(variant_source(source, edits))
        procs.append(build(f"vote_{name}", path, out_dir))
    libs = {"source": extd2._library("vote_lr")}
    for name, proc, so in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        libs[name[len("vote_"):]] = extd2.bind(so, "vote_lr")
    for shape in shapes:
        B, A, nmin, nmax, K, dist = VOTE_SHAPES[shape]
        s = vote_streams(B, A, nmin, nmax, dist)
        halves = []
        for n in ("keys", "qpos", "valid"):
            for off in (0, A + 1):
                a = s[n][:, off:off + A]
                halves.append(torch.from_numpy(np.ascontiguousarray(
                    a.view(np.int64) if a.dtype == np.uint64 else a)).cuda())
        fk, rk, fq, rq, fok, rok = halves
        _, _, ld, ptrs = vote._halves(fk, fq, fok, rk, rq, rok)
        per = {n: torch.from_numpy(s[n]).cuda() for n in ("extracted", "vt_distance", "cov_thr",
                                                           "lo1", "hi1", "lo2", "hi2")}
        stream = torch.cuda.current_stream().cuda_stream

        def entries(lib):
            o1 = {n: torch.empty((B,) if n == "out_len" else (B, K),
                                 dtype=torch.int64 if n.endswith("_t") else torch.int32,
                                 device="cuda") for n in vote.LR_OUTPUTS}
            o2 = torch.empty((B, 16), dtype=torch.int32, device="cuda")

            def r1():
                rc = lib.gdiet_vote_lr(*ptrs, ld, per["extracted"].data_ptr(),
                                       per["vt_distance"].data_ptr(), per["cov_thr"].data_ptr(),
                                       *(o1[n].data_ptr() for n in vote.LR_OUTPUTS), B, A, K,
                                       stream)
                if rc != 0:
                    raise RuntimeError(f"band_ablation: vote_lr failed, CUDA error {rc}")
                return [o1[n] for n in vote.LR_OUTPUTS]

            def r2():
                wins = (per[n].data_ptr() for n in ("lo1", "hi1", "lo2", "hi2"))
                rc = lib.gdiet_vote2_pair(*ptrs, ld, per["extracted"].data_ptr(),
                                          per["vt_distance"].data_ptr(), *wins,
                                          o2.data_ptr(), B, A, stream)
                if rc != 0:
                    raise RuntimeError(f"band_ablation: vote2_pair failed, CUDA error {rc}")
                return [o2]
            return {"round1": r1, "round2": r2}

        fns = {name: entries(lib) for name, lib in libs.items()}
        ref = {r: [x.clone() for x in fns["source"][r]()] for r in ("round1", "round2")}
        for name in fns:
            for r in ("round1", "round2"):
                if not all(torch.equal(a, b) for a, b in zip(fns[name][r](), ref[r])):
                    raise SystemExit(f"band_ablation: {name} differs from the source on {shape}")
        names = list(fns)
        out = {}
        for r, kern in (("round1", "vote_lr"), ("round2", "vote2_pair")):
            turns = {name: [] for name in names}
            for name in names + names[::-1]:
                turns[name].append(cs.device_ms(fns[name][r], kern))
            out[r] = {"device_ms": {k: float(np.mean(v)) if None not in v else None
                                    for k, v in turns.items()}, "device_turns_ms": turns}
        ok = s["valid"]
        n_valid = np.concatenate([ok[:, :A].sum(1), ok[:, A + 1:2 * A + 1].sum(1)])
        print(json.dumps({"shape": shape, "B": B, "A": A, "K": K,
                          "valid_per_half_mean": float(n_valid.mean()),
                          "valid_per_half_max": int(n_valid.max()), **out}), flush=True)


def fold_ablation(shapes, cs, out_dir) -> None:
    """The fold shapes: ``csrc/extd2_fold_i16.cu`` and FOLD_VARIANTS through
    ``extd2_batch``, in turns with ``csrc/extd2_fold.cu``; dirs exact
    against int32 (scores too where the variant walks)."""
    import numpy as np
    import torch

    from gdiet_tpu_torch.ops import extd2

    source = (extd2.CSRC / "extd2_fold_i16.cu").read_text()
    (out_dir / "dp_pair.cuh").write_text((extd2.CSRC / "dp_pair.cuh").read_text())
    procs = []
    for name, edits in FOLD_VARIANTS.items():
        path = out_dir / f"fold_{name}.cu"
        path.write_text(variant_source(source, edits))
        procs.append(build(f"fold_{name}", path, out_dir))
    cur = extd2._library("extd2_fold_i16")
    libs = {"source": cur}
    for name, proc, so in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        libs[name[len("fold_"):]] = extd2.bind(so, "extd2_fold_i16")
    for shape in shapes:
        N = FOLD_SHAPES[shape]
        q, t, ln, bd = (torch.from_numpy(a).cuda() for a in cs.dp_pairs(N, 160, 150))

        def with_lib(lib):
            def run():
                extd2._libs["extd2_fold_i16"] = lib
                try:
                    return extd2.extd2_batch(q, t, ln, bd, cs.PARAMS, 160, fold=True,
                                             state_dtype="int16")[:2]
                finally:
                    extd2._libs["extd2_fold_i16"] = cur
            return run

        fns = {name: with_lib(lib) for name, lib in libs.items()}
        fns["int32"] = lambda: extd2.extd2_batch(q, t, ln, bd, cs.PARAMS, 160, fold=True)[:2]
        ref = fns["int32"]()
        exact = {}
        for name, fn in fns.items():
            score, dirs = fn()
            exact[name] = {"score": bool(torch.equal(score, ref[0])),
                           "dirs": bool(torch.equal(dirs, ref[1]))}
            if not exact[name]["dirs"] or (name in ("source", "int32") and not exact[name]["score"]):
                raise SystemExit(f"band_ablation: {name} differs from the int32 kernel on {shape}")
        names = list(fns)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cs.rounds_ms(fns[name]))
        print(json.dumps({"shape": shape, "rows": N, "lanes": 160, "kernel": "extd2_fold_i16",
                          "ms": {k: float(np.mean(v)) for k, v in turns.items()},
                          "turns_ms": turns, "exact": exact}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prev", type=pathlib.Path, default=None,
                    help="a directory with an earlier extd2_band_i16.cu (no cluster size)")
    every = [*SHAPES, *FULL_SHAPES, *VOTE_SHAPES, *FOLD_SHAPES]
    ap.add_argument("--shapes", default=",".join(every), help="which of " + ", ".join(every))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[band_ablation] no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdiet_tpu_torch.ops import dp, dp_band, extd2

    print(cs.card_line(), flush=True)
    out_dir = extd2.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    shapes = args.shapes.split(",")
    full = [x for x in shapes if x in FULL_SHAPES]
    votes = [x for x in shapes if x in VOTE_SHAPES]
    folds = [x for x in shapes if x in FOLD_SHAPES]
    shapes = [x for x in shapes if x in SHAPES]
    if full:
        (out_dir / "dp_pair.cuh").write_text((extd2.CSRC / "dp_pair.cuh").read_text())
        full_ablation(full, cs, out_dir)
    if votes:
        vote_ablation(votes, cs, out_dir)
    if folds:
        fold_ablation(folds, cs, out_dir)
    if not shapes:
        return 0
    source = (extd2.CSRC / "extd2_band_i16.cu").read_text()
    procs = []
    for name, edits in VARIANTS.items():
        path = out_dir / f"{name}.cu"  # beside a copy of the shared header
        path.write_text(variant_source(source, edits))
        (out_dir / "dp_pair.cuh").write_text((extd2.CSRC / "dp_pair.cuh").read_text())
        procs.append(build(name, path, out_dir))
    if args.prev is not None:
        procs.append(build("earlier", args.prev / "extd2_band_i16.cu", out_dir))
    extd2.build_all(["extd2_band_i16", "extd2_band"])
    libs = {}
    for name, proc, so in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.gdiet_extd2_band_i16.restype = ctypes.c_int
        lib.gdiet_extd2_band_i16.argtypes = (extd2._DP_ARGS["extd2_band"] if name == "earlier"
                                             else extd2.ENTRIES["extd2_band_i16"]
                                             ["gdiet_extd2_band_i16"])
        libs[name] = lib

    U = dp_band.LR_UNROLL
    for shape in shapes:
        N, L, Lt, bb, preset, live = SHAPES[shape]
        params = cs.LR_PARAMS if preset == "hifi" else ONT_PARAMS
        Q, T, lens, tlens = cs.band_windows(N, L, Lt)
        lens[live:] = 0  # padding rows, as the long-read chunks pad to a power of two
        band = np.full(N, bb, np.int32)
        q, t, ln, bd, tl = (torch.from_numpy(a).cuda() for a in (Q, T, lens, band, tlens))
        Tp, R, WB = dp_band.band_shape(L, Lt, bb, U)
        C = extd2.band_i16_plan(N, L, WB, q.device)["cluster"]

        def direct(lib, with_cluster):
            def run():
                score = torch.empty((N,), dtype=torch.int32, device=q.device)
                dirs = torch.empty((N, R, WB), dtype=torch.uint8, device=q.device)
                rc = lib.gdiet_extd2_band_i16(
                    q.data_ptr(), t.data_ptr(), ln.data_ptr(), tl.data_ptr(), bd.data_ptr(),
                    score.data_ptr(), dirs.data_ptr(), N, L, Lt, Tp, R, WB, bb, U,
                    *dp.derive_scoring(params), *((C,) if with_cluster else ()),
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"band_ablation: launch failed, CUDA error {rc}")
                return score, dirs
            return run

        fns = {"source": lambda: extd2.extd2_batch(q, t, ln, bd, params, L, tlens=tl, Lt=Lt,
                                                   band_budget=bb, unroll=U,
                                                   state_dtype="int16")[:2]}
        fns.update({name: direct(lib, name != "earlier") for name, lib in libs.items()})
        ref = extd2.extd2_batch(q, t, ln, bd, params, L, tlens=tl, Lt=Lt, band_budget=bb,
                                unroll=U)
        exact = {}
        for name, fn in fns.items():
            score, dirs = fn()
            exact[name] = {"dirs": bool(torch.equal(dirs, ref[1])),
                           "score": bool(torch.equal(score, ref[0]))}
            if not exact[name]["dirs"] or (name != "no_walk" and not exact[name]["score"]):
                raise SystemExit(f"band_ablation: {name} differs from the int32 kernel on {shape}")
        names = list(fns)
        turns = {name: [] for name in names}
        reps = 2 if L > 8192 else 10
        for name in names + names[::-1]:
            fns[name]()
            turns[name].append(cs.rounds_ms(fns[name], reps))
        steps = cs.live_steps(lens, tlens)
        print(json.dumps({"shape": shape, "rows": N, "live_rows": live, "Lmax": L, "Lt": Lt,
                          "band_budget": bb, "cluster": C, "live_wavefronts": steps,
                          "ms": {k: float(np.mean(v)) for k, v in turns.items()},
                          "us_per_live_wavefront": {k: float(np.mean(v)) * 1e3 / steps
                                                    for k, v in turns.items()},
                          "turns_ms": turns, "exact": exact}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
