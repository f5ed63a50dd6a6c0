"""The reference's option parser: a frozen copy of the port's command-line
scan (``_tokenize``, ``_apply`` and the preset pass of ``main``), so that the
reference reads the published command line into its own
``IndexOptions``/``MapOptions`` and takes none of the program's.
"""

from __future__ import annotations

import sys

from benchmark.reference import config as cfg

__version__ = "reference"
HELP = ""
SR_PRESETS = {"sr", "short"}

_NUM_SUFFIX = {"k": 1e3, "K": 1e3, "m": 1e6, "M": 1e6, "g": 1e9, "G": 1e9}

def _parse_num(s: str) -> int:
    """mm_parse_num (main.c:96-110): 4k / 100M / 1G suffixes."""
    if s and s[-1] in _NUM_SUFFIX:
        return int(float(s[:-1]) * _NUM_SUFFIX[s[-1]] + 0.499)
    return int(float(s) + 0.499)


# option letter -> takes argument?
SHORT_OPTS = {
    "2": False, "a": False, "S": False, "D": False, "w": True, "k": True,
    "K": True, "t": True, "r": True, "f": True, "V": False, "v": True,
    "g": True, "G": True, "I": True, "d": True, "X": False, "T": True,
    "s": True, "x": True, "H": False, "c": False, "p": True, "M": True,
    "n": True, "z": True, "A": True, "B": True, "O": True, "E": True,
    "m": True, "N": True, "Q": False, "u": True, "R": True, "h": False,
    "F": True, "L": False, "C": True, "y": False, "Y": False, "P": False,
    "o": True, "e": True, "U": True, "Z": True, "W": True, "i": True,
}

LONG_OPTS_ARG = {
    "bucket-bits", "seed", "max-chain-skip", "max-chain-iter", "min-dp-len",
    "end-bonus", "end-seed-pen", "max-clip-ratio", "min-occ-floor",
    "score-N", "split-prefix", "cap-sw-mem", "max-qlen", "junc-bed",
    "junc-bonus", "chain-gap-scale", "chain-skip-scale", "alt", "alt-drop",
    "mask-len", "cap-kalloc", "q-occ-frac", "AF_dis", "AF_max_loc",
    "vt_dis", "vt_nb_loc", "vt_cov", "vt_df1", "vt_df2", "vt_f",
    "max_max_gap", "max_min_gap", "frag", "secondary", "sort", "variant",
    "batch", "split-reads", "mesh",
}


def _tokenize(argv: list[str]):
    """ketopt-style scan: (opt, arg) pairs and positional args."""
    out = []
    pos = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            body = tok[2:]
            if "=" in body:
                name, arg = body.split("=", 1)
                out.append((name, arg))
            elif body in LONG_OPTS_ARG:
                i += 1
                if i >= len(argv):
                    raise SystemExit(f"[ERROR] missing option argument for --{body}")
                out.append((body, argv[i]))
            else:
                out.append((body, None))
        elif tok.startswith("-") and len(tok) > 1:
            j = 1
            while j < len(tok):
                c = tok[j]
                if c not in SHORT_OPTS:
                    raise SystemExit(f"[ERROR] unknown option in \"{tok}\"")
                if SHORT_OPTS[c]:
                    if j + 1 < len(tok):
                        out.append((c, tok[j + 1 :]))
                    else:
                        i += 1
                        if i >= len(argv):
                            raise SystemExit("[ERROR] missing option argument")
                        out.append((c, argv[i]))
                    break
                out.append((c, None))
                j += 1
        else:
            pos.append(tok)
        i += 1
    return out, pos



def _apply(name: str, arg, io, mo, st) -> int | None:
    """One option (gdiet_tpu/cli.py:188-414). Returns an exit code where
    the option ends the run (-h, -V)."""
    if name == "w":
        io.w = int(arg)
    elif name == "k":
        io.k = int(arg)
    elif name == "Z":
        io.pattern = mo.pattern = arg
    elif name == "W":
        io.pattern_len = mo.pattern_len = int(arg)
    elif name == "i":
        mo.max_seeds = float(arg)
        if mo.max_seeds < 0:
            mo.max_seeds = 0.1
    elif name == "H":
        io.flag |= cfg.MM_I_HPC
    elif name == "d":
        st["fnw"] = arg
    elif name == "t":
        st["n_threads"] = int(arg)
    elif name == "v":
        st["verbose"] = int(arg)
    elif name == "g":
        mo.max_gap = _parse_num(arg)
    elif name == "F":
        parts = arg.split(",")
        mo.max_frag_len = _parse_num(parts[0])
        if len(parts) > 1:
            mo.max_nb_rounds = int(parts[1])
    elif name == "N":
        mo.best_n = int(arg)
    elif name == "p":
        mo.pri_ratio = float(arg)
    elif name == "M":
        mo.mask_level = float(arg)
    elif name == "c":
        mo.flag |= cfg.MM_F_OUT_CG | cfg.MM_F_CIGAR
    elif name == "a":
        mo.flag |= cfg.MM_F_OUT_SAM | cfg.MM_F_CIGAR
    elif name == "Q":
        mo.flag |= cfg.MM_F_NO_QUAL
    elif name == "Y":
        mo.flag |= cfg.MM_F_SOFTCLIP
    elif name == "L":
        mo.flag |= cfg.MM_F_LONG_CIGAR
    elif name == "y":
        mo.flag |= cfg.MM_F_COPY_COMMENT
    elif name == "T":
        mo.sdust_thres = int(arg)
    elif name == "n":
        parts = arg.split(",")
        mo.min_cnt = float(parts[0])
        if len(parts) > 1:
            mo.rec_threshold_frac = float(parts[1])
    elif name == "m":
        mo.min_chain_score = int(arg)
    elif name == "A":
        mo.a = int(arg)
    elif name == "B":
        mo.b = int(arg)
    elif name == "s":
        mo.min_dp_max = int(arg)
    elif name == "I":
        io.batch_size = _parse_num(arg)
    elif name in ("K", "batch"):
        mo.mini_batch_size = _parse_num(arg)
    elif name == "e":
        mo.occ_dist = _parse_num(arg)
    elif name in ("h", "help"):
        print(HELP)
        return 0
    elif name == "2":
        mo.flag |= cfg.MM_F_2_IO_THREADS
    elif name == "o":
        st["out_path"] = arg
    elif name in ("V", "version"):
        print(__version__)
        return 0
    elif name == "r":
        if st["variant"] == "lr":
            mo.bw = int(float(arg) + 0.499)
        else:
            parts = arg.split(",")
            x = float(parts[0])
            if x < 1.0:
                mo.bw_frac = x
                if len(parts) > 1:
                    mo.bw_min = int(parts[1])
                if len(parts) > 2:
                    mo.bw_max = int(parts[2])
            else:
                mo.bw = int(x + 0.499)
    elif name == "U":
        parts = arg.split(",")
        mo.min_mid_occ = int(parts[0])
        if len(parts) > 1:
            mo.max_mid_occ = int(parts[1])
    elif name == "f":
        parts = arg.split(",")
        x = float(parts[0])
        if x < 1.0:
            mo.mid_occ_frac, mo.mid_occ = x, 0
        else:
            mo.mid_occ = int(x + 0.499)
        if len(parts) > 1:
            mo.max_occ = int(float(parts[1]) + 0.499)
    elif name == "z":
        parts = arg.split(",")
        mo.zdrop = mo.zdrop_inv = int(parts[0])
        if len(parts) > 1:
            mo.zdrop_inv = int(parts[1])
    elif name == "O":
        parts = arg.split(",")
        mo.q = mo.q2 = int(parts[0])
        if len(parts) > 1:
            mo.q2 = int(parts[1])
    elif name == "E":
        parts = arg.split(",")
        mo.e = mo.e2 = int(parts[0])
        if len(parts) > 1:
            mo.e2 = int(parts[1])
    elif name == "bucket-bits":
        io.bucket_bits = int(arg)
    elif name == "seed":
        mo.seed = int(arg)
    elif name == "min-occ-floor":
        mo.min_mid_occ = int(arg)
    elif name == "q-occ-frac":
        mo.q_occ_frac = float(arg)
    elif name == "max-qlen":
        mo.max_qlen = _parse_num(arg)
    elif name == "idx-no-seq":
        io.flag |= cfg.MM_I_NO_SEQ
    elif name == "eqx":
        mo.flag |= cfg.MM_F_EQX
    elif name == "MD":
        mo.flag |= cfg.MM_F_OUT_MD
    elif name == "cs":
        mo.flag |= cfg.MM_F_OUT_CS | cfg.MM_F_CIGAR
        if arg == "long":
            mo.flag |= cfg.MM_F_OUT_CS_LONG
        elif arg == "none":
            mo.flag &= ~cfg.MM_F_OUT_CS
        else:
            mo.flag &= ~cfg.MM_F_OUT_CS_LONG
    elif name == "paf-no-hit":
        mo.flag |= cfg.MM_F_PAF_NO_HIT
    elif name == "for-only":
        mo.flag |= cfg.MM_F_FOR_ONLY
    elif name == "rev-only":
        mo.flag |= cfg.MM_F_REV_ONLY
    elif name == "split-prefix":
        mo.split_prefix = arg
    elif name == "AF_dis":
        mo.AF_dis = float(arg)
    elif name == "AF_max_loc":
        mo.AF_max_loc = int(float(arg))
    elif name in ("vt_dis", "vt_nb_loc", "max_max_gap", "max_min_gap"):
        setattr(mo, name, int(arg))
    elif name in ("vt_cov", "vt_df1", "vt_df2", "vt_f"):
        setattr(mo, name, float(arg))
    elif name == "secondary":
        if arg in ("yes", "y"):
            mo.flag &= ~cfg.MM_F_NO_PRINT_2ND
        elif arg in ("no", "n"):
            mo.flag |= cfg.MM_F_NO_PRINT_2ND
    elif name == "sort":
        if arg == "radix":
            mo.flag = (mo.flag | cfg.MM_F_RADIX_SORT) & ~cfg.MM_F_HEAP_SORT
        elif arg == "heap":
            mo.flag = (mo.flag | cfg.MM_F_HEAP_SORT) & ~cfg.MM_F_RADIX_SORT
        elif arg == "merge":
            mo.flag &= ~(cfg.MM_F_HEAP_SORT | cfg.MM_F_RADIX_SORT)
        else:
            raise SystemExit("[ERROR]: Unknown sort algorithm (merge, radix, heap)")
    elif name == "G":
        mo.max_gap_ref = _parse_num(arg)
    elif name == "frag":
        if arg in ("yes", "y", None):
            mo.flag |= cfg.MM_F_FRAG_MODE
        elif arg in ("no", "n"):
            mo.flag &= ~cfg.MM_F_FRAG_MODE
    elif name == "mesh":
        # --mesh DATAxREF: reads over DATA rows, the index over REF key
        # ranges (runtime.run_mapping, parallel/dist.py)
        parts = arg.lower().split("x")
        mo.mesh_shape = (int(parts[0]), int(parts[1]) if len(parts) > 1 else 1)
    elif name == "split-reads":
        mo.split_len = _parse_num(arg)
    elif st["verbose"] >= 2:
        # parsed for compatibility; dead in the GDiet hot path
        print(f"[WARNING]\x1b[1;31m option '{'--' if len(name) > 1 else '-'}{name}"
              f" is accepted but has no effect in gdiet_tpu_torch\x1b[0m",
              file=sys.stderr)
    return None


def parse(argv: list[str]):
    """(io, mo, variant, n_threads) of a command line's options."""
    opts, _ = _tokenize(list(argv))
    preset = variant = None
    for name, arg in opts:
        if name == "x":
            preset = arg
        elif name == "variant":
            variant = {"short": "sr", "sr": "sr", "long": "lr", "lr": "lr"}[arg]
    if variant is None:
        variant = "sr" if preset in SR_PRESETS else "lr"
    io, mo = cfg.IndexOptions(), cfg.MapOptions()
    if variant == "lr":
        mo.bw = 1000
    if preset is not None:
        cfg.set_preset(preset, io, mo)
    if variant == "lr":
        cfg.apply_cli_defaults_lr(io, mo)
    else:
        cfg.apply_cli_defaults(io, mo)
    st = {"fnw": None, "out_path": None, "n_threads": 3, "verbose": 3,
          "variant": variant}
    for name, arg in opts:
        if name not in ("x", "variant"):
            if _apply(name, arg, io, mo, st) is not None:
                raise ValueError(f"option {name} ends the run")
    if io.pattern_len < 2:
        io.pattern_len = mo.pattern_len = 2
        io.pattern = mo.pattern = "11"
    cfg.check_options(io, mo)
    return io, mo, variant, st["n_threads"]
