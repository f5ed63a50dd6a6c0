"""Command line of the port: short-read mapping to SAM on a GPU.

  python -m gdiet_tpu_torch -a -x sr -Z 10 -W 2 -k 21 -w 11 -i 2 -N 1 \
      -r 0.05,150,200 -n 0.95,0.3 -s 100 --AF_max_loc 2 ref.fa reads.fq

Two query files (``r1.fq r2.fq``) map as pairs. ``GDIET_DP_FOLD=1`` runs
the DP through the folded kernel where the banded lane window cannot
engage, as in ``gdiet_tpu``.

Options keep the letters and syntax of ``gdiet_tpu.cli`` (the reference's
main.c), whose tokenizer is reused; this parser handles the short-read
subset. ``--device`` (default ``cuda``) picks the torch device; without a
GPU, ``cuda`` is an error. The target is FASTA (indexed on the device) or an
npz index saved by either package.
"""

from __future__ import annotations

import sys

from gdiet_tpu_torch import _host

HELP = """Usage: python -m gdiet_tpu_torch [options] <target.fa>|<target.gdi.npz> <query.fq> [<query2.fq>]
Short-read (-x sr) mapping to SAM on a GPU with PyTorch/CUDA; two query
files map as pairs. Options:
  -x sr      preset (short-read presets only)
  -Z STR/-W INT  sparsification pattern / its length
  -i FLOAT   max seeds for pattern-shift inference (a count if >= 1,
             a fraction of the read length if < 1)
  -k/-w INT  k-mer size / minimizer window
  -a         SAM output (required)      -o FILE  output [stdout]
  -d FILE    dump the index (npz)       -t INT   host threads for the oracle
  -N INT  -r frac[,min,max]  -n F[,F2]  -s INT  -A/-B/-O/-E  --AF_max_loc INT
  --device DEV   torch device [cuda]
"""


def _apply(name, arg, io, mo, st) -> None:
    cfg = _host.config
    num = st["parse_num"]
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
        mo.occ_dist = num(arg)
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
    from gdiet_tpu import cli as jcli  # option tokenizer (no JAX)

    opts, pos = jcli._tokenize(rest)
    names = {n for n, _ in opts}
    if names & {"h", "help"}:
        print(HELP)
        return 0
    if names & {"V", "version"}:
        print(_host.__version__)
        return 0
    cfg = _host.config
    preset = next((a for n, a in opts if n == "x"), None)
    if preset not in jcli.SR_PRESETS:
        raise SystemExit("[ERROR] gdiet_tpu_torch maps short reads only: "
                         "give -x sr")
    io, mo = cfg.IndexOptions(), cfg.MapOptions()
    cfg.set_preset(preset, io, mo)
    cfg.apply_cli_defaults(io, mo)
    st = {"fnw": None, "out_path": None, "n_threads": 3, "verbose": 3,
          "parse_num": jcli._parse_num}
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
        io, mo, "sr", target=pos[0], queries=pos[1:], device=device,
        fnw=st["fnw"], out_path=st["out_path"], n_threads=st["n_threads"],
        verbose=st["verbose"], cli_line="gdiet " + " ".join(argv))


if __name__ == "__main__":
    sys.exit(main())
