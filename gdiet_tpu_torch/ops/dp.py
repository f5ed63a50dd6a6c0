"""Batched banded dual affine-gap extension: the plain torch version.

Port of ``gdiet_tpu/ops/dp.py::extd2_batch`` (ksw_extd2's Suzuki-Kasahara
difference recurrence, GDiet-ShortReads/ksw2_extd2_sse.c:34-402, evaluated
over anti-diagonals with [N, T] int32 lanes; see that module's docstring for
the 16-lane stale-block behaviour it replicates). It is the reference for the
CUDA kernels in ``csrc/extd2.cu`` and ``csrc/extd2_i16.cu`` and what
``ops/extd2.py`` runs for tensors on the CPU. ``calls`` counts its
invocations, so a GPU run can show that its main path never came here.

``state_dtype`` is the counterpart of ``extd2_batch_pallas``'s parameter
(``gdiet_tpu/ops/dp_pallas.py``): "int16" keeps the seven lane-state
tensors in ``torch.int16`` (int16 arithmetic, wrapping as the TPU kernel's
does) and the per-row H0 and score in int32. ``safe_state_dtype`` says
when that is exact; "int16" outside its bound raises ``ValueError``.
"""

from __future__ import annotations

import torch

from gdiet_tpu_torch.ops import LaunchCount

NEG_INF = -0x40000000

CIGAR_MATCH, CIGAR_INS, CIGAR_DEL = 0, 1, 2

calls = LaunchCount()


def cigars_from_ops(ops, fin_i, fin_j, lens) -> list:
    """Run-length encode back-to-front op streams (>= 3 = padding) into
    (len, op) CIGARs, adding the leading-gap leftovers (ksw2.h:157-158);
    the host counterpart of native.rle_ops (gdiet_tpu/ops/dp.py:246-280)."""
    cigars = []
    for n in range(len(lens)):
        if lens[n] <= 0:
            cigars.append([])
            continue
        row = ops[n]
        run: list = []
        for opv in row[row < 3].tolist():
            if run and run[-1][1] == opv:
                run[-1] = (run[-1][0] + 1, opv)
            else:
                run.append((1, opv))
        for left, op in ((int(fin_i[n]), CIGAR_DEL), (int(fin_j[n]), CIGAR_INS)):
            if left >= 0:
                if run and run[-1][1] == op:
                    run[-1] = (run[-1][0] + left + 1, op)
                else:
                    run.append((left + 1, op))
        run.reverse()
        cigars.append(run)
    return cigars


def safe_state_dtype(params) -> str:
    """"int16" when the scoring provably fits the 16-bit lane state, else
    "int32" (dp_pallas.py:140): the lane values of the difference
    formulation are bounded by a few gap costs (ksw2_extd2_sse.c:34), and
    a 4x safety bound must still fit int16."""
    a, b, q, e, q2, e2 = (int(p) for p in params)
    return "int16" if 4 * (a + b + q + e + q2 + e2) < 32767 else "int32"


def state_dtype_of(params, state_dtype: str) -> torch.dtype:
    """The torch dtype of the lane state for ``state_dtype`` ("int32" or
    "int16"); "int16" with scoring outside ``safe_state_dtype``'s bound
    raises ValueError (the assert of dp_pallas.py:794), it never falls back
    to int32."""
    if state_dtype not in ("int32", "int16"):
        raise ValueError(f"state_dtype must be 'int32' or 'int16', not {state_dtype!r}")
    if state_dtype == "int16" and safe_state_dtype(params) != "int16":
        raise ValueError(f"state_dtype='int16' is not exact for the scoring {tuple(params)}: "
                         "4*(a+b+q+e+q2+e2) must stay below 32767")
    return torch.int16 if state_dtype == "int16" else torch.int32


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def round16(x: int) -> int:
    return round_up(x, 16)


def boundary_u(r: int, qe: int, e: int, e2: int, long_thres: int,
               long_diff: int) -> int:
    """Boundary u value at wavefront r (ksw2_extd2_sse.c:149-163)."""
    if r == 0:
        return -qe
    if r < long_thres:
        return -e
    return long_diff if r == long_thres else -e2


def derive_scoring(params) -> tuple:
    """(a, b, q, e, q2, e2, long_thres, long_diff) with q+e <= q2+e2
    (ksw2_extd2_sse.c:78-83)."""
    a, b, q, e, q2, e2 = (int(p) for p in params)
    if q2 + e2 < q + e:
        q, q2, e, e2 = q2, q, e2, e
    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2
    return a, b, q, e, q2, e2, long_thres, long_diff


def band_geometry(lens, tlens, band, R: int, T: int):
    """Per-wavefront 16-aligned live lane range in closed form
    (ksw2_extd2_sse.c:121-137): offs [N, R] (T where dead) and off_ends
    [N, R] (-1 where dead), as ops/dp.py returns them."""
    dev = lens.device
    r = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    qlen = lens.to(torch.int32)[:, None]
    tlen = qlen if tlens is None else tlens.to(torch.int32)[:, None]
    w = band.to(torch.int32)[:, None]
    st0 = torch.maximum(torch.clamp(r - qlen + 1, min=0), (r - w + 1) >> 1)
    en0 = torch.minimum(torch.minimum(tlen - 1, r), (r + w) >> 1)
    live = (st0 <= en0) & (r < qlen + tlen - 1) & (qlen > 0)
    st = st0 // 16 * 16
    en = torch.clamp((en0 + 16) // 16 * 16 - 1, max=T - 1)
    offs = torch.where(live, st, torch.full_like(st, T))
    off_ends = torch.where(live, en, torch.full_like(en, -1))
    return offs, off_ends


def extd2_batch(query, target, lens, band, params, Lmax: int, tlens=None,
                Lt: int | None = None, state_dtype: str = "int32"):
    """Returns (score [N] i32, dirs [N, R, T] u8, offs [N, R] i32,
    off_ends [N, R] i32) with R = Lmax+Lt-1 and T = Lt rounded up to 16,
    exactly as ``gdiet_tpu.ops.dp.extd2_batch``. Rows with lens == 0 score
    NEG_INF. ``state_dtype``: the lane state's type (see the module)."""
    sdt = state_dtype_of(params, state_dtype)
    calls.n += 1
    N = query.shape[0]
    dev = query.device
    if Lt is None:
        Lt = Lmax
    T = round16(Lt)
    TQ = round16(Lmax)
    R = Lmax + Lt - 1
    a, b, q, e, q2, e2, long_thres, long_diff = derive_scoring(params)
    i32 = torch.int32

    qlen = lens.to(i32)
    tlen = qlen if tlens is None else tlens.to(i32)
    w = band.to(i32)
    lanes = torch.arange(T, dtype=i32, device=dev)[None, :]

    def full(v, dtype=sdt):
        return torch.full((N, T), v, dtype=dtype, device=dev)

    u, v, x, y = full(-(q + e)), full(-(q + e)), full(-(q + e)), full(-(q + e))
    x2, y2, s = full(-(q2 + e2)), full(-(q2 + e2)), full(0)
    sf = full(0, i32)
    sf[:, : target.shape[1]] = target.to(i32)
    qpad = torch.zeros((N, TQ), dtype=i32, device=dev)
    qpad[:, :Lmax] = query.to(i32)

    zeros_n = torch.zeros((N,), dtype=i32, device=dev)
    H0 = zeros_n.clone()
    last_H0_t = zeros_n.clone()
    last_st = zeros_n - 1
    last_en = zeros_n - 1
    score = torch.full((N,), NEG_INF, dtype=i32, device=dev)
    col0 = torch.zeros((N, 1), dtype=sdt, device=dev)
    dirs = torch.empty((N, R, T), dtype=torch.uint8, device=dev)
    offs = torch.empty((N, R), dtype=i32, device=dev)
    off_ends = torch.empty((N, R), dtype=i32, device=dev)

    def take(arr, idx):
        return torch.gather(arr, 1, idx[:, None].to(torch.int64))[:, 0]

    for r in range(R):
        st0 = torch.clamp(torch.maximum(r - qlen + 1, (r - w + 1) >> 1), min=0)
        en0 = torch.minimum(torch.clamp(tlen - 1, max=r), (r + w) >> 1)
        live = (st0 <= en0) & (r < qlen + tlen - 1) & (qlen > 0)
        st = st0 // 16 * 16
        en = torch.clamp((en0 + 16) // 16 * 16 - 1, max=T - 1)

        # boundary values (ksw2_extd2_sse.c:149-163)
        stm1 = torch.clamp(st - 1, 0, T - 1)
        prev_ok = (st > 0) & (st - 1 >= last_st) & (st - 1 <= last_en)
        x1 = torch.where(prev_ok, take(x, stm1), -(q + e))
        x21 = torch.where(prev_ok, take(x2, stm1), -(q2 + e2))
        bu = boundary_u(r, q + e, e, e2, long_thres, long_diff)
        v1 = torch.where(st > 0, torch.where(prev_ok, take(v, stm1), -(q + e)), bu)

        # edge-lane init at t == r (ksw2_extd2_sse.c:160-163)
        at_edge = (lanes == r) & (en[:, None] >= r) & live[:, None]
        y = torch.where(at_edge, -(q + e), y)
        y2 = torch.where(at_edge, -(q2 + e2), y2)
        u = torch.where(at_edge, bu, u)

        # substitution scores for lanes [st0, st0 + 16*ceil(span/16))
        span16 = (en0 - st0) // 16 * 16 + 16
        in_s = (lanes >= st0[:, None]) & (lanes < (st0 + span16)[:, None]) & live[:, None]
        qi = r - lanes[0]
        qv = torch.where(
            (qi >= 0)[None, :] & (qi[None, :] < qlen[:, None]),
            qpad[:, torch.clamp(qi, 0, TQ - 1).to(torch.int64)], 0,
        )
        nmask = (sf == 4) | (qv == 4)
        sval = torch.where(sf == qv, a, -b).to(sdt)
        sval = torch.where(nmask, -e2, sval)
        s = torch.where(in_s, sval, s)

        in_al = (lanes >= st[:, None]) & (lanes <= en[:, None]) & live[:, None]
        at_st = lanes == st[:, None]
        x_prev = torch.where(at_st, x1[:, None], torch.cat([col0, x[:, :-1]], 1))
        v_prev = torch.where(at_st, v1[:, None], torch.cat([col0, v[:, :-1]], 1))
        x2_prev = torch.where(at_st, x21[:, None], torch.cat([col0, x2[:, :-1]], 1))

        zv = s
        a_ = x_prev + v_prev
        b_ = y + u
        a2_ = x2_prev + v_prev
        b2_ = y2 + u
        d = (a_ > zv).to(i32)
        zv = torch.maximum(zv, a_)
        d = torch.where(b_ > zv, 2, d)
        zv = torch.maximum(zv, b_)
        d = torch.where(a2_ > zv, 3, d)
        zv = torch.maximum(zv, a2_)
        d = torch.where(b2_ > zv, 4, d)
        zv = torch.maximum(zv, b2_)
        zv = torch.clamp(zv, max=a)

        u_new = zv - v_prev
        v_new = zv - u
        a_p = a_ - (zv - q)
        b_p = b_ - (zv - q)
        a2_p = a2_ - (zv - q2)
        b2_p = b2_ - (zv - q2)
        d = (d | ((a_p > 0).to(i32) << 3) | ((b_p > 0).to(i32) << 4)
             | ((a2_p > 0).to(i32) << 5) | ((b2_p > 0).to(i32) << 6))
        u = torch.where(in_al, u_new, u)
        v = torch.where(in_al, v_new, v)
        x = torch.where(in_al, torch.clamp(a_p, min=0) - (q + e), x)
        y = torch.where(in_al, torch.clamp(b_p, min=0) - (q + e), y)
        x2 = torch.where(in_al, torch.clamp(a2_p, min=0) - (q2 + e2), x2)
        y2 = torch.where(in_al, torch.clamp(b2_p, min=0) - (q2 + e2), y2)
        dirs[:, r, :] = torch.where(in_al, d, 0).to(torch.uint8)

        # approximate H0 tracking (ksw2_extd2_sse.c:367-383) on the
        # updated lanes
        lt = last_H0_t
        lt_in = (lt >= st0) & (lt <= en0)
        lt1_in = (lt + 1 >= st0) & (lt + 1 <= en0)
        v_lt = take(v, torch.clamp(lt, 0, T - 1))
        u_lt1 = take(u, torch.clamp(lt + 1, 0, T - 1))
        both = lt_in & lt1_in
        d0gt = v_lt > u_lt1
        H0_new = torch.where(
            both, torch.where(d0gt, H0 + v_lt, H0 + u_lt1),
            torch.where(lt_in, H0 + v_lt, H0 + u_lt1),
        )
        lt_new = torch.where(both, torch.where(d0gt, lt, lt + 1),
                             torch.where(lt_in, lt, lt + 1))
        if r == 0:
            H0_new = v[:, 0].to(i32) - (q + e)
            lt_new = zeros_n
        H0 = torch.where(live, H0_new, H0)
        last_H0_t = torch.where(live, lt_new, last_H0_t)

        hit_end = live & (r == qlen + tlen - 2) & (en0 == tlen - 1)
        score = torch.where(hit_end, H0, score)

        last_st = torch.where(live, st, last_st)
        last_en = torch.where(live, en, last_en)
        offs[:, r] = torch.where(live, st, T)
        off_ends[:, r] = torch.where(live, en, -1)
    return score, dirs, offs, off_ends
