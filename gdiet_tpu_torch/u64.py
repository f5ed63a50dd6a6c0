"""uint64 bit patterns carried in ``torch.int64``.

The JAX step carries minimizer hashes, cuckoo keys, packed CSR values
(``start << 24 | count``) and vote keys (``chrom << 32 | pos``) as uint64,
with ``0xFFFF_FFFF_FFFF_FFFF`` sentinels that must sort last. ``torch.uint64``
has no shift, compare, min or sort, so the port keeps the same 64 bits in
``int64`` and spells out the three operations whose signed meaning differs:

- logical right shift: ``srl(x, s) = (x >> s) & (2**(64-s) - 1)``;
- unsigned order: flip the sign bit (``ordered``) and compare, take minima
  or sort as signed — ``U64_MAX`` then maps to ``INT64_MAX`` and sorts last;
- the cuckoo range map ``((q*c) >> 32) * NB >> 32`` (``index/cuckoo.py``),
  whose constants have bit 63 set: multiplication wraps modulo 2**64 in both
  representations, and every shift is logical.

Addition, subtraction, multiplication, ``&``, ``|``, ``^``, ``~``, ``<<`` and
equality give the same bits as uint64.
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)  # the sign bit as an int64 value
U64_MAX = -1  # 0xFFFF_FFFF_FFFF_FFFF
ORD_MAX = (1 << 63) - 1  # ordered(U64_MAX)
ORD_MIN = SIGN  # ordered(0)
U32 = 0xFFFFFFFF


def as_i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >> 63 else c


def from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint64 -> int64 tensor of the same bits (on ``device``)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))
    return t if device is None else t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 of the same bits."""
    return t.detach().cpu().numpy().astype(np.int64, copy=False).view(np.uint64)


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a constant ``0 <= s < 64``."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def ordered(x: torch.Tensor) -> torch.Tensor:
    """Map unsigned order onto signed order (an involution)."""
    return x ^ SIGN


def ule(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ordered(a) <= ordered(b)


def argsort_u64(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable ascending argsort in unsigned order."""
    return torch.sort(ordered(x), dim=dim, stable=True).indices


def range_map(q: torch.Tensor, c: int, n: int) -> torch.Tensor:
    """Cuckoo bucket id ``((q*c) >> 32) * n >> 32`` (index/cuckoo.py:46-50)."""
    t = srl(q * as_i64(c), 32)
    return srl(t * n, 32)
