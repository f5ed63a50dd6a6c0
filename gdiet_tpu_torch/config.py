"""Index / mapping option dataclasses and presets.

Field names and defaults mirror the reference's ``mm_idxopt_t`` /
``mm_mapopt_t`` (GDiet-ShortReads/minimap.h:134-203, options.c:5-62) plus the
GDiet-specific CLI defaults applied after preset selection
(GDiet-ShortReads/main.c:164-172; GDiet-LongReads/main.c:169-185), so that a
user of the reference can carry their command lines over unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# Flag bits (GDiet-ShortReads/minimap.h:24-63). Only the ones the GDiet hot
# path consults are given semantics here; the rest are accepted for CLI parity.
# ---------------------------------------------------------------------------
MM_F_NO_DIAG = 0x001
MM_F_NO_DUAL = 0x002
MM_F_CIGAR = 0x004
MM_F_OUT_SAM = 0x008
MM_F_NO_QUAL = 0x010
MM_F_OUT_CG = 0x020
MM_F_OUT_CS = 0x040
MM_F_SPLICE = 0x080
MM_F_SPLICE_FOR = 0x100
MM_F_SPLICE_REV = 0x200
MM_F_NO_LJOIN = 0x400
MM_F_OUT_CS_LONG = 0x800
MM_F_SR = 0x1000
MM_F_FRAG_MODE = 0x2000
MM_F_NO_PRINT_2ND = 0x4000
MM_F_2_IO_THREADS = 0x8000
MM_F_HEAP_SORT = 0x10000
MM_F_ALL_CHAINS = 0x20000
MM_F_OUT_MD = 0x40000
MM_F_COPY_COMMENT = 0x80000
MM_F_EQX = 0x100000
MM_F_PAF_NO_HIT = 0x200000
MM_F_NO_END_FLT = 0x400000
MM_F_RADIX_SORT = 0x800000
MM_F_FOR_ONLY = 0x1000000
MM_F_REV_ONLY = 0x2000000
MM_F_QSTRAND = 0x4000000
MM_F_NO_INV = 0x8000000
MM_F_RMQ = 0x10000000
MM_F_SOFTCLIP = 0x20000000
MM_F_LONG_CIGAR = 0x40000000

MM_I_HPC = 0x1
MM_I_NO_SEQ = 0x2
MM_I_NO_NAME = 0x4

# CIGAR operation codes (minimap.h MM_CIGAR_*)
CIGAR_MATCH, CIGAR_INS, CIGAR_DEL, CIGAR_N_SKIP = 0, 1, 2, 3
CIGAR_SOFTCLIP, CIGAR_HARDCLIP, CIGAR_PADDING = 4, 5, 6
CIGAR_EQ_MATCH, CIGAR_X_MISMATCH = 7, 8
CIGAR_STR = "MIDNSHP=XB"


@dataclass
class IndexOptions:
    """Reference parity: mm_idxopt_t (minimap.h:134-141, options.c:5-11)."""

    k: int = 15
    w: int = 10
    flag: int = 0
    bucket_bits: int = 14
    mini_batch_size: int = 50_000_000
    batch_size: int = 4_000_000_000
    # GDiet pattern (main.c:171-172); "11" (W=2) disables sparsification.
    pattern: str = "11"
    pattern_len: int = 2


@dataclass
class MapOptions:
    """Reference parity: mm_mapopt_t (minimap.h:142-203, options.c:13-62)
    with GDiet CLI defaults layered on top (main.c:164-170)."""

    flag: int = 0
    seed: int = 11
    sdust_thres: int = 0

    max_qlen: int = 0

    bw: int = 0
    bw_min: int = 500
    bw_max: int = 1500
    bw_frac: float = 0.05
    max_gap: int = 5000
    max_gap_ref: int = -1
    max_frag_len: int = 0
    max_chain_skip: int = 25
    max_chain_iter: int = 5000
    # NOTE: the reference's post-preset CLI default is 1 (main.c:168); the sr
    # preset's 2 (options.c:142) is always overwritten. We reproduce that.
    min_cnt: float = 1.0
    min_chain_score: int = 40
    chain_gap_scale: float = 0.8
    chain_skip_scale: float = 0.0
    rmq_size_cap: int = 100_000
    rmq_inner_dist: int = 1000
    rmq_rescue_size: int = 1000
    rmq_rescue_ratio: float = 0.1

    mask_level: float = 0.5
    mask_len: int = 2**31 - 1
    pri_ratio: float = 0.8
    best_n: int = 5

    alt_drop: float = 0.15

    a: int = 2  # match score
    b: int = 4  # mismatch penalty
    q: int = 4  # gap open 1
    e: int = 2  # gap ext 1
    q2: int = 24  # gap open 2
    e2: int = 1  # gap ext 2
    sc_ambi: int = 1
    noncan: int = 0
    junc_bonus: int = 0
    zdrop: int = 400
    zdrop_inv: int = 200
    end_bonus: int = -1
    min_dp_max: int = 80  # min_chain_score * a
    min_ksw_len: int = 200
    anchor_ext_len: int = 20
    anchor_ext_shift: int = 6
    max_clip_ratio: float = 1.0

    rank_min_len: int = 500
    rank_frac: float = 0.9

    pe_ori: int = 0
    pe_bonus: int = 33

    mid_occ_frac: float = 2e-4
    q_occ_frac: float = 0.01
    min_mid_occ: int = 10
    max_mid_occ: int = 1_000_000
    mid_occ: int = 0  # 0 => derived from index quantile (mm_mapopt_update)
    max_occ: int = 0
    max_max_occ: int = 4095
    occ_dist: int = 500

    mini_batch_size: int = 500_000_000
    max_sw_mat: int = 100_000_000
    cap_kalloc: int = 1_000_000_000

    split_prefix: str | None = None
    split_len: int = 0  # >0: split reads longer than this (ultralong ONT)
    mesh_shape: tuple | None = None  # (n_data, n_ref) multi-chip mesh

    # ---- GDiet-specific (main.c:164-170; LongReads main.c:82-90,169-185) ----
    pattern: str = "11"
    pattern_len: int = 2
    max_seeds: float = 0.1  # -i: count if >=1, fraction of read length if <1
    rec_threshold_frac: float = 0.0  # second value of -n
    max_nb_rounds: int = 1
    # ShortReads adjacency filtering
    AF_dis: float = 1.0
    AF_max_loc: int = 20
    # LongReads two-round voting (LongReads main.c:82-90,169-185)
    vt_dis: int = 500
    vt_nb_loc: int = 10
    vt_cov: float = 0.06
    vt_df1: float = 0.01
    vt_df2: float = 0.06
    vt_f: float = 0.06
    max_max_gap: int = 5000
    max_min_gap: int = 100

    def scoring(self) -> tuple[int, int, int, int, int, int]:
        return self.a, self.b, self.q, self.e, self.q2, self.e2


PRESETS = (
    "map-ont",
    "ava-ont",
    "map10k",
    "map-pb",
    "ava-pb",
    "map-hifi",
    "map-ccs",
    "asm5",
    "asm10",
    "asm20",
    "short",
    "sr",
    "splice",
    "splice:hq",
    "cdna",
)


def set_preset(preset: str | None, io: IndexOptions, mo: MapOptions) -> None:
    """Reference parity: mm_set_opt (options.c:84-162).

    Mutates ``io``/``mo`` in place; raises ValueError on unknown preset.
    """
    if preset is None:
        return
    if preset == "map-ont":
        pass  # same as defaults
    elif preset == "ava-ont":
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_chain_skip = 100, 0.0, 25
        mo.occ_dist = 0
    elif preset in ("map10k", "map-pb"):
        io.flag |= MM_I_HPC
        io.k = 19
    elif preset == "ava-pb":
        io.flag |= MM_I_HPC
        io.k, io.w = 19, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_chain_skip = 100, 0.0, 25
        mo.occ_dist = 0
    elif preset in ("map-hifi", "map-ccs"):
        io.flag, io.k, io.w = 0, 19, 19
        mo.max_gap = 10000
        mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
        mo.occ_dist = 500
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        mo.min_dp_max = 200
    elif preset.startswith("asm"):
        io.flag, io.k, io.w = 0, 19, 19
        mo.max_gap = 10000
        mo.flag |= MM_F_RMQ
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        mo.min_dp_max = 200
        mo.best_n = 50
        if preset == "asm5":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 19, 39, 81, 3, 1
            mo.zdrop = mo.zdrop_inv = 200
        elif preset == "asm10":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 9, 16, 41, 2, 1
            mo.zdrop = mo.zdrop_inv = 200
        elif preset == "asm20":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
            mo.zdrop = mo.zdrop_inv = 200
            io.w = 10
        else:
            raise ValueError(f"unknown preset: {preset}")
    elif preset in ("short", "sr"):
        io.flag, io.k, io.w = 0, 21, 11
        mo.flag |= (
            MM_F_SR | MM_F_FRAG_MODE | MM_F_NO_PRINT_2ND | MM_F_2_IO_THREADS | MM_F_HEAP_SORT
        )
        mo.pe_ori = 0 << 1 | 1  # FR
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 2, 8, 12, 2, 24, 1
        mo.zdrop = mo.zdrop_inv = 100
        mo.end_bonus = 10
        mo.max_frag_len = 800
        mo.max_nb_rounds = 1
        mo.max_gap = 100
        mo.pri_ratio = 0.5
        mo.min_cnt = 2
        mo.min_chain_score = 25
        mo.min_dp_max = 40
        mo.best_n = 20
        mo.mid_occ = 1000
        mo.max_occ = 5000
        mo.mini_batch_size = 50_000_000
    elif preset.startswith("splice") or preset == "cdna":
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= MM_F_SPLICE | MM_F_SPLICE_FOR | MM_F_SPLICE_REV
        mo.max_sw_mat = 0
        mo.max_gap, mo.max_gap_ref = 2000, 200_000
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 2, 2, 1, 32, 0
        mo.noncan = 9
        mo.junc_bonus = 9
        mo.zdrop, mo.zdrop_inv = 200, 100
        if preset == "splice:hq":
            mo.junc_bonus, mo.b, mo.q, mo.q2 = 5, 4, 6, 24
    else:
        raise ValueError(f"unknown preset: {preset}")


def apply_cli_defaults(io: IndexOptions, mo: MapOptions) -> None:
    """GDiet defaults applied after preset selection (main.c:164-172)."""
    mo.pattern, mo.pattern_len = "11", 2
    io.pattern, io.pattern_len = "11", 2
    mo.max_seeds = 0.1
    mo.AF_dis = 1.0
    mo.min_cnt = 1.0
    mo.rec_threshold_frac = 0.0
    mo.AF_max_loc = 20


def apply_cli_defaults_lr(io: IndexOptions, mo: MapOptions) -> None:
    """Long-read variant defaults (GDiet-LongReads/main.c:169-185 plus the
    LR mm_mapopt_init deltas, GDiet-LongReads/options.c:22-24)."""
    mo.bw = 1000  # LR mm_mapopt_init: plain bandwidth, no frac/min/max
    mo.pattern, mo.pattern_len = "11", 2
    io.pattern, io.pattern_len = "11", 2
    mo.max_seeds = 0.1
    mo.vt_dis = 100
    mo.min_cnt = 1
    mo.vt_nb_loc = 3
    mo.vt_cov = 0.03
    mo.vt_df1 = 0.01
    mo.vt_df2 = 0.01
    mo.vt_f = 0.05
    mo.max_max_gap = 50000
    mo.min_dp_max = 40
    mo.max_min_gap = 4000
    mo.rec_threshold_frac = 0.0


def check_options(io: IndexOptions, mo: MapOptions) -> None:
    """Reference parity: mm_check_opt (options.c:164-244). Raises ValueError."""
    if io.k <= 0 or io.w <= 0:
        raise ValueError("-k and -w must be positive")
    if mo.best_n < 0:
        raise ValueError("-N must be no less than 0")
    if not (0.0 <= mo.pri_ratio <= 1.0):
        raise ValueError("-p must be within 0 and 1")
    if (mo.flag & MM_F_FOR_ONLY) and (mo.flag & MM_F_REV_ONLY):
        raise ValueError("--for-only and --rev-only can't be applied at the same time")
    if mo.e <= 0 or mo.q <= 0:
        raise ValueError("-O and -E must be positive")
    if (mo.q != mo.q2 or mo.e != mo.e2) and not (mo.e > mo.e2 and mo.q + mo.e < mo.q2 + mo.e2):
        raise ValueError("dual gap penalties violating E1>E2 and O1+E1<O2+E2")
    if (mo.q + mo.e) + (mo.q2 + mo.e2) > 127:
        raise ValueError("scoring system violating ({-O}+{-E})+({-O2}+{-E2}) <= 127")
    if mo.zdrop < mo.zdrop_inv:
        raise ValueError("Z-drop should not be less than inversion-Z-drop")
    if (mo.flag & MM_F_NO_PRINT_2ND) and (mo.flag & MM_F_ALL_CHAINS):
        raise ValueError("-X/-P and --secondary=no can't be applied at the same time")
    if len(mo.pattern) != mo.pattern_len:
        raise ValueError("pattern string length must equal pattern_len")
    if any(c not in "01" for c in mo.pattern):
        raise ValueError("pattern must consist of 0/1 characters")
    if "1" not in mo.pattern:
        raise ValueError("pattern must contain at least one 1")


def options_for(
    preset: str | None = None, variant: str = "sr", **overrides
) -> tuple[IndexOptions, MapOptions]:
    """Convenience constructor: defaults -> preset -> GDiet CLI defaults ->
    user overrides (matching the reference's two-pass CLI parse order).

    ``variant`` selects the ShortReads ("sr") or LongReads ("lr") sibling's
    post-preset CLI defaults.
    """
    io, mo = IndexOptions(), MapOptions()
    set_preset(preset, io, mo)
    if variant == "lr":
        apply_cli_defaults_lr(io, mo)
    else:
        apply_cli_defaults(io, mo)
    io_fields = {f.name for f in dataclasses.fields(IndexOptions)}
    mo_fields = {f.name for f in dataclasses.fields(MapOptions)}
    for key, val in overrides.items():
        hit = False
        if key in io_fields:
            setattr(io, key, val)
            hit = True
        if key in mo_fields:
            setattr(mo, key, val)
            hit = True
        if not hit:
            raise TypeError(f"unknown option: {key}")
    if "pattern" in overrides and "pattern_len" not in overrides:
        io.pattern_len = mo.pattern_len = len(overrides["pattern"])
    # W<2 coerces pattern off (main.c:385-389)
    if mo.pattern_len < 2 or io.pattern_len < 2:
        io.pattern = mo.pattern = "11"
        io.pattern_len = mo.pattern_len = 2
    check_options(io, mo)
    return io, mo
