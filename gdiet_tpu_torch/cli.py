"""Command line of the port: short-read and long-read mapping to SAM on a GPU.

  python -m gdiet_tpu_torch -a -x sr -Z 10 -W 2 -k 21 -w 11 -i 2 -N 1 \
      -r 0.05,150,200 -n 0.95,0.3 -s 100 --AF_max_loc 2 ref.fa reads.fq
  python -m gdiet_tpu_torch -a -x map-hifi -Z 10 -W 2 -k 19 -w 19 -i 0.2 \
      -r 200 --vt_dis=650 --vt_nb_loc=5 ref.fa hifi.fq

Two query files (``r1.fq r2.fq``) map short reads as pairs.
``GDIET_DP_FOLD=1`` runs the short-read DP through the folded kernel where
the banded lane window cannot engage, as in ``gdiet_tpu``. Presets ``sr`` /
``short`` select the short-read pipeline, ``map-hifi``, ``map-ont``,
``map-pb`` and ``map-ccs`` the long-read one (``--variant`` overrides).

Options keep the letters and syntax of ``gdiet_tpu/cli.py`` (the
reference's main.c); the tokenizer below is a copy of its ketopt-style
scan, and this parser handles the subset the port maps. ``--device``
(default ``cuda``) picks the torch device; without a GPU, ``cuda`` is an
error. The target is FASTA (indexed on the device) or an npz index saved by
either package.
"""

from __future__ import annotations

import sys

from gdiet_tpu_torch import __version__, config as cfg

SR_PRESETS = {"sr", "short"}
LR_PRESETS = {"map-hifi", "map-ont", "map-pb", "map-ccs"}

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


HELP = """Usage: python -m gdiet_tpu_torch [options] <target.fa>|<target.gdi.npz> <query.fq> [<query2.fq>]
Short-read (-x sr) and long-read (-x map-hifi|map-ont|map-pb|map-ccs)
mapping to SAM on a GPU with PyTorch/CUDA; two short-read query files map
as pairs. Options:
  -x STR     preset: sr, map-hifi, map-ont, map-pb, map-ccs
  -Z STR/-W INT  sparsification pattern / its length
  -i FLOAT   max seeds for pattern-shift inference (a count if >= 1,
             a fraction of the read length if < 1)
  -k/-w INT  k-mer size / minimizer window
  -a         SAM output (required)      -o FILE  output [stdout]
  -d FILE    dump the index (npz)       -t INT   host threads
  -r ...     bandwidth: short: frac[,min,max]; long: INT
  -N INT  -n F[,F2]  -s INT  -A/-B/-O/-E  --AF_max_loc INT
  --vt_dis/--vt_nb_loc/--vt_cov/--vt_df1/--vt_df2/--vt_f   long-read voting
  --device DEV   torch device [cuda]
"""


def _apply(name, arg, io, mo, st) -> None:
    if name == "w":
        io.w = int(arg)
    elif name == "k":
        io.k = int(arg)
    elif name == "Z":
        io.pattern = mo.pattern = arg
    elif name == "W":
        io.pattern_len = mo.pattern_len = int(arg)
    elif name == "i":
        mo.max_seeds = float(arg) if float(arg) >= 0 else 0.1
    elif name == "d":
        st["fnw"] = arg
    elif name == "t":
        st["n_threads"] = int(arg)
    elif name == "v":
        st["verbose"] = int(arg)
    elif name == "N":
        mo.best_n = int(arg)
    elif name == "a":
        mo.flag |= cfg.MM_F_OUT_SAM | cfg.MM_F_CIGAR
    elif name == "Y":
        mo.flag |= cfg.MM_F_SOFTCLIP
    elif name == "n":
        parts = arg.split(",")
        mo.min_cnt = float(parts[0])
        if len(parts) > 1:
            mo.rec_threshold_frac = float(parts[1])
    elif name == "A":
        mo.a = int(arg)
    elif name == "B":
        mo.b = int(arg)
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
    elif name == "s":
        mo.min_dp_max = int(arg)
    elif name == "e":
        mo.occ_dist = _parse_num(arg)
    elif name == "f":
        parts = arg.split(",")
        x = float(parts[0])
        if x < 1.0:
            mo.mid_occ_frac, mo.mid_occ = x, 0
        else:
            mo.mid_occ = int(x + 0.499)
        if len(parts) > 1:
            mo.max_occ = int(float(parts[1]) + 0.499)
    elif name == "U":
        parts = arg.split(",")
        mo.min_mid_occ = int(parts[0])
        if len(parts) > 1:
            mo.max_mid_occ = int(parts[1])
    elif name == "o":
        st["out_path"] = arg
    elif name == "r":
        if st["variant"] == "lr":
            mo.bw = int(float(arg) + 0.499)
            return
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
    elif name == "q-occ-frac":
        mo.q_occ_frac = float(arg)
    elif name == "AF_dis":
        mo.AF_dis = float(arg)
    elif name == "AF_max_loc":
        mo.AF_max_loc = int(float(arg))
    elif name in ("vt_dis", "vt_nb_loc"):
        setattr(mo, name, int(arg))
    elif name in ("vt_cov", "vt_df1", "vt_df2", "vt_f"):
        setattr(mo, name, float(arg))
    elif name == "secondary":
        if arg in ("yes", "y"):
            mo.flag &= ~cfg.MM_F_NO_PRINT_2ND
        elif arg in ("no", "n"):
            mo.flag |= cfg.MM_F_NO_PRINT_2ND
    elif name == "frag":
        if arg in ("yes", "y", None):
            mo.flag |= cfg.MM_F_FRAG_MODE
        elif arg in ("no", "n"):
            mo.flag &= ~cfg.MM_F_FRAG_MODE
    else:
        raise SystemExit(f"[ERROR] option '{'--' if len(name) > 1 else '-'}{name}' "
                         "is not supported by gdiet_tpu_torch yet")


def main(argv: list | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    rest = []
    i = 0
    while i < len(argv):  # --device is the port's own option
        if argv[i] == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            i += 2
        elif argv[i].startswith("--device="):
            device = argv[i].split("=", 1)[1]
            i += 1
        else:
            rest.append(argv[i])
            i += 1
    opts, pos = _tokenize(rest)
    names = {n for n, _ in opts}
    if names & {"h", "help"}:
        print(HELP)
        return 0
    if names & {"V", "version"}:
        print(__version__)
        return 0
    # pass 1: preset and variant (main.c:148-162)
    preset = next((a for n, a in opts if n == "x"), None)
    variant = next((a for n, a in opts if n == "variant"), None)
    if variant is not None:
        variant = {"short": "sr", "sr": "sr", "long": "lr", "lr": "lr"}.get(variant)
        if variant is None:
            raise SystemExit("[ERROR] unknown variant (short|long)")
    if preset not in SR_PRESETS | LR_PRESETS:
        raise SystemExit("[ERROR] gdiet_tpu_torch maps with the presets "
                         f"{', '.join(sorted(SR_PRESETS | LR_PRESETS))}: give -x")
    if variant is None:
        variant = "sr" if preset in SR_PRESETS else "lr"
    io, mo = cfg.IndexOptions(), cfg.MapOptions()
    if variant == "lr":
        mo.bw = 1000
    cfg.set_preset(preset, io, mo)
    if variant == "lr":
        cfg.apply_cli_defaults_lr(io, mo)
    else:
        cfg.apply_cli_defaults(io, mo)
    st = {"fnw": None, "out_path": None, "n_threads": 3, "verbose": 3,
          "variant": variant}
    for name, arg in opts:
        if name not in ("x", "variant"):
            _apply(name, arg, io, mo, st)
    if io.pattern_len < 2:
        io.pattern_len = mo.pattern_len = 2
        io.pattern = mo.pattern = "11"
    try:
        cfg.check_options(io, mo)
    except ValueError as ex:
        raise SystemExit(f"[ERROR] {ex}")
    if not pos:
        print(HELP)
        return 1
    if len(pos) == 1 and st["fnw"] is None:
        raise SystemExit("[ERROR] missing input: please specify a query file "
                         "or use -d to build an index")
    from gdiet_tpu_torch.runtime import run_mapping

    return run_mapping(
        io, mo, variant, target=pos[0], queries=pos[1:], device=device,
        fnw=st["fnw"], out_path=st["out_path"], n_threads=st["n_threads"],
        verbose=st["verbose"], cli_line="gdiet " + " ".join(argv))


if __name__ == "__main__":
    sys.exit(main())
