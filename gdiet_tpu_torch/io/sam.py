"""SAM / PAF record formatting.

Semantics re-derived from GDiet-ShortReads/format.c: header (mm_write_sam_hdr
format.c:128-148), per-record fields/flags (mm_write_sam3 format.c:412-602),
tags (write_tags format.c:292-324), CIGAR with clips (write_sam_cigar
format.c:387-410), and PAF (mm_write_paf3 format.c:326-358).

Only the single-segment (n_seg == 1) path is implemented so far; paired-end
mate fields arrive with the pe layer.
"""

from __future__ import annotations

from gdiet_tpu_torch.config import (
    CIGAR_STR,
    MM_F_COPY_COMMENT,
    MM_F_LONG_CIGAR,
    MM_F_OUT_CS,
    MM_F_OUT_CS_LONG,
    MM_F_OUT_MD,
    MM_F_SOFTCLIP,
)
from gdiet_tpu_torch.oracle.align import Reg, event_identity
from gdiet_tpu_torch.oracle.sketch import seq_to_code

_NT = "ACGTN"
_NT_LOW = "acgtn"

_COMP = str.maketrans("ACGTUacgtuRYSWKMBDHVN", "TGCAAtgcaaYRSWMKVHDBN")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def sam_header(names: list[str], lengths: list[int], cli: str | None = None,
               version: str = "0.1.0") -> str:
    lines = [f"@SQ\tSN:{n}\tLN:{l}" for n, l in zip(names, lengths)]
    pg = f"@PG\tID:gdiet\tPN:gdiet\tVN:{version}"
    if cli:
        pg += f"\tCL:{cli}"
    lines.append(pg)
    return "\n".join(lines) + "\n"


def _tags(r: Reg) -> str:
    """write_tags (format.c:292-324)."""
    t = "P" if r.id == r.parent else "S"
    if r.inv:
        t = "I" if r.id == r.parent else "i"
    s = f"\tNM:i:{r.blen - r.mlen + r.n_ambi}\tms:i:{r.dp_max}\tAS:i:{r.dp_score}\tnn:i:{r.n_ambi}"
    s += f"\ttp:A:{t}\tcm:i:{r.cnt}\ts1:i:{r.score}"
    if r.parent == r.id:
        s += f"\ts2:i:{r.subsc}"
    div = 1.0 - event_identity(r)
    s += "\tde:f:0" if div == 0.0 else f"\tde:f:{div:.4f}"
    if r.split:
        s += f"\tzd:i:{r.split}"
    return s


def gen_cs_md(index, r: Reg, seq: str, is_MD: bool, no_iden: bool = True) -> str:
    """cs / MD tag body (write_cs_core / write_MD_core, format.c:150-236)."""
    codes = seq_to_code(seq)
    if not r.rev:
        q = codes[r.qs : r.qe]
    else:
        sub = codes[r.qs : r.qe][::-1]
        import numpy as np

        q = np.where(sub >= 4, 4, 3 - sub).astype(sub.dtype)
    t = index.getseq(r.rid, r.rs, r.re)
    out: list[str] = []
    qo = to = 0
    if is_MD:
        l_md = 0
        for length, op in r.cigar:
            if op in (0, 7, 8):  # M/=/X
                for j in range(length):
                    if q[qo + j] != t[to + j]:
                        out.append(f"{l_md}{_NT[t[to + j]]}")
                        l_md = 0
                    else:
                        l_md += 1
                qo += length
                to += length
            elif op == 1:
                qo += length
            elif op == 2:
                out.append(f"{l_md}^" + "".join(_NT[c] for c in t[to : to + length]))
                l_md = 0
                to += length
            elif op == 3:
                to += length
        if l_md > 0:
            out.append(str(l_md))
        return "".join(out)
    for length, op in r.cigar:
        if op in (0, 7, 8):
            run = 0
            buf: list[str] = []
            for j in range(length):
                if q[qo + j] != t[to + j]:
                    if run > 0:
                        out.append("=" + "".join(buf) if not no_iden else f":{run}")
                        run = 0
                        buf = []
                    out.append(f"*{_NT_LOW[t[to + j]]}{_NT_LOW[q[qo + j]]}")
                else:
                    run += 1
                    buf.append(_NT[q[qo + j]])
            if run > 0:
                out.append("=" + "".join(buf) if not no_iden else f":{run}")
            qo += length
            to += length
        elif op == 1:
            out.append("+" + "".join(_NT_LOW[c] for c in q[qo : qo + length]))
            qo += length
        elif op == 2:
            out.append("-" + "".join(_NT_LOW[c] for c in t[to : to + length]))
            to += length
        else:  # intron
            out.append(
                f"~{_NT_LOW[t[to]]}{_NT_LOW[t[to + 1]]}{length}"
                f"{_NT_LOW[t[to + length - 2]]}{_NT_LOW[t[to + length - 1]]}"
            )
            to += length
    return "".join(out)


def _sam_cigar(r: Reg, qlen: int, sam_flag: int, opt_flag: int) -> str:
    """write_sam_cigar (format.c:387-410)."""
    if not r.cigar:
        return "*"
    clip0 = qlen - r.qe if r.rev else r.qs
    clip1 = r.qs if r.rev else qlen - r.qe
    clip_char = "H" if (sam_flag & 0x800) and not (opt_flag & MM_F_SOFTCLIP) else "S"
    out = []
    if clip0:
        out.append(f"{clip0}{clip_char}")
    for length, op in r.cigar:
        out.append(f"{length}{CIGAR_STR[op]}")
    if clip1:
        out.append(f"{clip1}{clip_char}")
    return "".join(out)


def qname_len(name: str) -> int:
    """mm_qname_len: length without a trailing /<digit> suffix."""
    l = len(name)
    if l >= 3 and name[-1].isdigit() and name[-2] == "/":
        return l - 2
    return l


def qname_same(a: str, b: str) -> bool:
    """mm_qname_same: equal after trimming /<digit> suffixes."""
    la, lb = qname_len(a), qname_len(b)
    return la == lb and a[:la] == b[:la]


def _sam_pri(regs: list[Reg] | None) -> Reg | None:
    """get_sam_pri (format.c:379-385)."""
    if regs:
        for q in regs:
            if q.sam_pri:
                return q
    return None


def sam_record(
    name: str,
    seq: str,
    qual: str | None,
    r: Reg | None,
    regs: list[Reg],
    ref_names: list[str],
    opt_flag: int = 0,
    rep_len: int = 0,
    seg_idx: int = 0,
    n_seg: int = 1,
    mate_regs: list[Reg] | None = None,
    index=None,
    comment: str | None = None,
) -> str:
    """mm_write_sam3 (format.c:412-602). For paired segments (n_seg > 1)
    pass the mate's regs to fill flags 0x1/0x40/0x80/0x8/0x20 and
    RNEXT/PNEXT/TLEN."""
    qlen = len(seq)
    r_next = _sam_pri(mate_regs) if n_seg > 1 else None
    r_prev = r_next  # n_seg == 2 (format.c:432-434)
    flag = 0x1 if n_seg > 1 else 0
    if r is None:
        flag |= 0x4
    else:
        if r.rev:
            flag |= 0x10
        if r.parent != r.id:
            flag |= 0x100
        elif not r.sam_pri:
            flag |= 0x800
    if n_seg > 1:
        if r is not None and getattr(r, "proper_frag", 0):
            flag |= 0x2
        if seg_idx == 0:
            flag |= 0x40
        elif seg_idx == n_seg - 1:
            flag |= 0x80
        if r_next is None:
            flag |= 0x8
        elif r_next.rev:
            flag |= 0x20
    out_name = name[: qname_len(name)] if n_seg > 1 else name
    fields = [out_name, str(flag)]
    this_rid = this_pos = -1
    if r is None:
        if r_prev is not None:
            this_rid, this_pos = r_prev.rid, r_prev.rs
            fields += [ref_names[this_rid], str(this_pos + 1), "0", "*"]
        else:
            fields += ["*", "0", "0", "*"]
    else:
        this_rid, this_pos = r.rid, r.rs
        # -L: BAM caps one CIGAR at 65535 ops; move it to the CG:B:I tag
        # and leave a placeholder <seq>S<ref>N CIGAR (format.c:414,476-491)
        cigar_in_tag = False
        if (opt_flag & MM_F_LONG_CIGAR) and r.cigar \
                and len(r.cigar) > 65535 - 2:
            n_cig = len(r.cigar) + (r.qs != 0) + (r.qe != qlen)
            cigar_in_tag = n_cig > 65535
        if cigar_in_tag:
            if (flag & 0x900) == 0 or (opt_flag & MM_F_SOFTCLIP):
                slen = qlen
            elif flag & 0x100:
                slen = 0
            else:
                slen = r.qe - r.qs
            cig_field = f"{slen}S{r.re - r.rs}N"
        else:
            cig_field = _sam_cigar(r, qlen, flag, opt_flag)
        fields += [ref_names[r.rid], str(r.rs + 1), str(r.mapq), cig_field]
    if n_seg > 1:
        tlen = 0
        if this_rid >= 0 and r_next is not None:
            if this_rid == r_next.rid:
                if r is not None:
                    p5 = r.re - 1 if r.rev else this_pos
                    n5 = r_next.re - 1 if r_next.rev else r_next.rs
                    tlen = n5 - p5
                fields += ["=", str(r_next.rs + 1)]
            else:
                fields += [ref_names[r_next.rid], str(r_next.rs + 1)]
        elif r_next is not None:
            fields += [ref_names[r_next.rid], str(r_next.rs + 1)]
        elif this_rid >= 0:
            fields += ["=", str(this_pos + 1)]
        else:
            fields += ["*", "0"]
        if tlen > 0:
            tlen += 1
        elif tlen < 0:
            tlen -= 1
        fields += [str(tlen)]
    else:
        fields += ["*", "0", "0"]
    # SEQ / QUAL (format.c:533-559)
    if r is None:
        fields += [seq, qual or "*"]
    elif (flag & 0x900) == 0 or (opt_flag & MM_F_SOFTCLIP):
        fields += [revcomp(seq) if r.rev else seq,
                   (qual[::-1] if r.rev else qual) if qual else "*"]
    elif flag & 0x100:
        fields += ["*", "*"]
    else:
        sub = seq[r.qs : r.qe]
        subq = qual[r.qs : r.qe] if qual else None
        fields += [revcomp(sub) if r.rev else sub,
                   (subq[::-1] if r.rev else subq) if subq else "*"]
    out = "\t".join(fields)
    if r is not None:
        out += _tags(r)
        # SA tag for co-primary (supplementary) alignments (format.c:566-591)
        if r.parent == r.id and r.cigar and len(regs) > 1:
            others = [q for q in regs if q is not r and q.parent == q.id and q.cigar]
            if others:
                sa = "\tSA:Z:"
                for q in others:
                    if q.qe - q.qs < q.re - q.rs:
                        l_M, l_I, l_D = q.qe - q.qs, 0, (q.re - q.rs) - (q.qe - q.qs)
                    else:
                        l_M, l_I, l_D = q.re - q.rs, (q.qe - q.qs) - (q.re - q.rs), 0
                    clip5 = qlen - q.qe if q.rev else q.qs
                    clip3 = q.qs if q.rev else qlen - q.qe
                    sa += f"{ref_names[q.rid]},{q.rs + 1},{'-' if q.rev else '+'},"
                    if clip5:
                        sa += f"{clip5}S"
                    if l_M:
                        sa += f"{l_M}M"
                    if l_I:
                        sa += f"{l_I}I"
                    if l_D:
                        sa += f"{l_D}D"
                    if clip3:
                        sa += f"{clip3}S"
                    sa += f",{q.mapq},{q.blen - q.mlen + q.n_ambi};"
                out += sa
        if r.cigar and index is not None and (opt_flag & (MM_F_OUT_CS | MM_F_OUT_MD)):
            if opt_flag & MM_F_OUT_MD:
                out += "\tMD:Z:" + gen_cs_md(index, r, seq, True)
            else:
                out += "\tcs:Z:" + gen_cs_md(
                    index, r, seq, False, not (opt_flag & MM_F_OUT_CS_LONG)
                )
        if cigar_in_tag:  # write_sam_cigar in_tag=1 (format.c:394-401,595)
            clip_op = 5 if (flag & 0x800) and not (opt_flag & MM_F_SOFTCLIP) else 4
            clip0 = qlen - r.qe if r.rev else r.qs
            clip1 = r.qs if r.rev else qlen - r.qe
            cg = ["\tCG:B:I"]
            if clip0:
                cg.append(f",{(clip0 << 4) | clip_op}")
            for length, op in r.cigar:
                cg.append(f",{(length << 4) | op}")
            if clip1:
                cg.append(f",{(clip1 << 4) | clip_op}")
            out += "".join(cg)
    if rep_len >= 0:
        out += f"\trl:i:{rep_len}"
    if (opt_flag & MM_F_COPY_COMMENT) and comment:  # -y (format.c:599)
        out += f"\t{comment}"
    return out


def paf_record(
    name: str,
    qlen: int,
    r: Reg | None,
    ref_names: list[str],
    ref_lens: list[int],
    rep_len: int = 0,
    out_cigar: bool = False,
    opt_flag: int = 0,
    comment: str | None = None,
) -> str:
    """mm_write_paf3 (format.c:326-358)."""
    if r is None:
        s = f"{name}\t{qlen}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0"
        if rep_len >= 0:
            s += f"\trl:i:{rep_len}"
        if (opt_flag & MM_F_COPY_COMMENT) and comment:
            s += f"\t{comment}"
        return s
    s = (
        f"{name}\t{qlen}\t{r.qs}\t{r.qe}\t{'-' if r.rev else '+'}\t"
        f"{ref_names[r.rid]}\t{ref_lens[r.rid]}\t{r.rs}\t{r.re}\t"
        f"{r.mlen}\t{r.blen}\t{r.mapq}"
    )
    s += _tags(r)
    if rep_len >= 0:
        s += f"\trl:i:{rep_len}"
    if out_cigar and r.cigar:
        s += "\tcg:Z:" + "".join(f"{l}{CIGAR_STR[op]}" for l, op in r.cigar)
    if (opt_flag & MM_F_COPY_COMMENT) and comment:  # -y (format.c:357)
        s += f"\t{comment}"
    return s
