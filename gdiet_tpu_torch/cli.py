"""Command line of the port: the whole gdiet_tpu CLI on a GPU.

  python -m gdiet_tpu_torch -a -x sr -Z 10 -W 2 -k 21 -w 11 -i 2 -N 1 \
      -r 0.05,150,200 -n 0.95,0.3 -s 100 --AF_max_loc 2 ref.fa reads.fq
  python -m gdiet_tpu_torch -c --cs -x sr ... ref.fa reads.fq      # PAF
  python -m gdiet_tpu_torch -a -x map-hifi -Z 10 -W 2 -k 19 -w 19 -i 0.2 \
      -r 200 --vt_dis=650 --vt_nb_loc=5 ref.fa hifi.fq

Options keep the letters, syntax and effect of ``gdiet_tpu/cli.py`` (the
reference's main.c): the tokenizer and the option loop below are copies of
its ketopt-style scan and its parser, and set the same
``IndexOptions``/``MapOptions`` fields; options whose semantics are dead in
the GDiet hot path warn and go on. Two query files (``r1.fq r2.fq``) map
short reads as pairs. Presets ``sr`` / ``short`` select the short-read
pipeline, all others the long-read one (``--variant`` overrides).

``--device`` (default ``cuda``) is the port's own option and picks the
torch device; without a GPU, ``cuda`` is an error. The target is FASTA
(indexed on the device) or an npz index saved by either package.
"""

from __future__ import annotations

import sys

from gdiet_tpu_torch import __version__, config as cfg, debug

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


HELP = """Usage: python -m gdiet_tpu_torch [options] <target.fa>|<target.gdi.npz> [query.fa/q [...]]
The gdiet_tpu read mapper on a GPU with PyTorch/CUDA. Options mirror the
reference GDiet binaries; presets sr/short select the short-read pipeline,
all others the long-read pipeline (override with --variant short|long).
Key options:
  -x STR     preset: sr, map-ont, map-hifi, map-pb, asm5/10/20, ava-*
  -Z STR     1/0 sparsification pattern (e.g. 10, 110, 1110)  [11]
  -W INT     pattern length  [2]
  -i FLOAT   max seeds for pattern-shift inference (<1: fraction of read)
  -k/-w INT  k-mer size / minimizer window
  -d FILE    dump the index to FILE (npz)
  -a         output SAM (default PAF)   -c  PAF with CIGAR (cg:Z)
  --MD, --cs[=short|long|none]   MD / cs tags;  -y  copy FASTQ comments
  -o FILE    output file  [stdout]
  -t INT     host worker threads
  -N INT     max secondary alignments
  -r ...     bandwidth: short: frac[,min,max]; long: INT
  -n F[,F2]  vote threshold fraction [, recovery fraction]
  -s INT     min DP score to output
  -I NUM     index part size; with --split-prefix, map part by part
  --AF_max_loc INT   short-read: max voted locations per read
  --vt_dis/--vt_nb_loc/--vt_cov/--vt_df1/--vt_df2/--vt_f   long-read voting
  --split-reads NUM  cut reads longer than NUM into chunks
  --secondary yes|no   output secondary alignments
  --device DEV   torch device [cuda]
  --version  print version
"""


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
    elif name == "print-seeds":
        # stage-trace oracle (main.c:289-298): every read maps through the
        # scalar oracle on one thread, tracing to stderr
        debug.set_print_seed(True)
        st["n_threads"] = 1
    elif st["verbose"] >= 2:
        # parsed for compatibility; dead in the GDiet hot path
        print(f"[WARNING]\x1b[1;31m option '{'--' if len(name) > 1 else '-'}{name}"
              f" is accepted but has no effect in gdiet_tpu_torch\x1b[0m",
              file=sys.stderr)
    return None


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
    # pass 1: preset and variant (main.c:148-162)
    preset = None
    variant = None
    for name, arg in opts:
        if name == "x":
            preset = arg
        elif name == "variant":
            variant = {"short": "sr", "sr": "sr", "long": "lr", "lr": "lr"}.get(arg)
            if variant is None:
                raise SystemExit(f"[ERROR] unknown variant '{arg}'")
    if variant is None:
        variant = "sr" if preset in SR_PRESETS else "lr"
    io, mo = cfg.IndexOptions(), cfg.MapOptions()
    if variant == "lr":
        mo.bw = 1000
    if preset is not None:
        try:
            cfg.set_preset(preset, io, mo)
        except ValueError as ex:
            raise SystemExit(f"[ERROR] {ex}")
    if variant == "lr":
        cfg.apply_cli_defaults_lr(io, mo)
    else:
        cfg.apply_cli_defaults(io, mo)
    st = {"fnw": None, "out_path": None, "n_threads": 3, "verbose": 3,
          "variant": variant}
    for name, arg in opts:
        if name not in ("x", "variant"):
            rc = _apply(name, arg, io, mo, st)
            if rc is not None:
                return rc
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
