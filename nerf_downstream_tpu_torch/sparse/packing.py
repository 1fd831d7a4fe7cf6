"""Coordinate packing, sorting and exact search over packed keys.

Counterpart of ``nerf_downstream_tpu/sparse/packing.py``. A batched
coordinate ``(b, x, y, z)`` packs into a 64-bit key kept as two 32-bit
words, ``hi = b:11 | x:20`` and ``lo = y:16 | z:16`` (biased), compared as
unsigned numbers. torch has no full uint32 arithmetic, so the words travel
as int32 bit views (the same views the CUDA match kernel reads) and the
arithmetic runs in int64. Sorting uses ONE int64 key per row: the sign bit
of ``hi`` is flipped so that signed int64 order equals unsigned (hi, lo)
order, which keeps ``INVALID_KEY`` (0xFFFFFFFF) rows last.

Supported ranges: batch < 2048, x in [-2^19, 2^19), y, z in [-2^15, 2^15).
"""

from __future__ import annotations

import torch

_X_BITS = 20
_Y_BITS = 16
_Z_BITS = 16
_X_BIAS = 1 << (_X_BITS - 1)
_Y_BIAS = 1 << (_Y_BITS - 1)
_Z_BIAS = 1 << (_Z_BITS - 1)
_U32 = 0xFFFFFFFF

# int32 bit views of the sentinels: 0xFFFFFFFF marks invalid rows (both
# words); masked queries carry hi=0xFFFFFFFF, lo=0xFFFFFFFE, a pair no
# packed or padding key holds.
INVALID_KEY = -1
MASKED_LO = -2


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 bit view."""
    u = u & _U32
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def to_u32(v: torch.Tensor) -> torch.Tensor:
    """int32 bit view -> its uint32 value in int64."""
    return v.to(torch.int64) & _U32


def key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 per key whose signed order is the unsigned (hi, lo) order."""
    return (to_u32(hi) - (1 << 31)) * (1 << 32) + to_u32(lo)


def pack(coords: torch.Tensor, mask: torch.Tensor):
    """int coords [N, 4] + validity mask [N] -> (hi, lo) int32 bit views.

    Invalid rows get ``INVALID_KEY`` in both words: they sort last and
    never match a lookup query.
    """
    c = coords.to(torch.int64)
    b = c[:, 0] & _U32
    x = (c[:, 1] + _X_BIAS) & _U32
    y = (c[:, 2] + _Y_BIAS) & _U32
    z = (c[:, 3] + _Z_BIAS) & _U32
    hi = ((b << _X_BITS) & _U32) | (x & ((1 << _X_BITS) - 1))
    lo = ((y << _Z_BITS) & _U32) | (z & ((1 << _Z_BITS) - 1))
    hi = torch.where(mask, to_i32(hi), INVALID_KEY)
    lo = torch.where(mask, to_i32(lo), INVALID_KEY)
    return hi, lo


def sort_with_payload(hi, lo, *payload):
    """Stable sort by unsigned (hi, lo), carrying payload tensors along."""
    order = torch.sort(key64(hi, lo), stable=True).indices
    return (hi[order], lo[order]) + tuple(p[order] for p in payload)


def lower_bound(s_hi, s_lo, q_hi, q_lo):
    """Per query, the first index i with sorted[i] >= query, by the same
    fixed-step binary search as the reference (``bit_length(N)`` rounds,
    gathers clamped to the last row), so every result is bit-identical —
    including its overshoot to N + 1 when a query exceeds every key of a
    table without padding rows."""
    return lower_bound_keys(key64(s_hi, s_lo), key64(q_hi, q_lo))


def lower_bound_keys(s, q):
    """``lower_bound`` over ``key64`` values: table ``s`` [N], queries
    ``q`` of any shape."""
    n = s.shape[0]
    lo_i = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi_i = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    for _ in range(max(1, n.bit_length())):
        mid = (lo_i + hi_i) >> 1
        less = s[mid.clamp(max=n - 1)] < q
        lo_i, hi_i = torch.where(less, mid + 1, lo_i), torch.where(
            less, hi_i, mid
        )
    return lo_i.to(torch.int32)


def lower_bound_hier(s_hi, s_lo, q_hi, q_lo, block: int = 256):
    """``lower_bound`` as a two-level count: block-top keys below the query
    pick a candidate block, then the keys below the query inside it are
    counted. Exact for a sorted table; used for tile-boundary queries."""
    n = s_hi.shape[0]
    if n % block or n <= block:
        return lower_bound(s_hi, s_lo, q_hi, q_lo)
    return lower_bound_hier_keys(
        key64(s_hi, s_lo), key64(q_hi.reshape(-1), q_lo.reshape(-1)),
        block).reshape(q_hi.shape)


def lower_bound_hier_keys(s, q, block: int = 256):
    """``lower_bound_hier`` over ``key64`` values: table ``s`` [N], queries
    ``q`` [Q]."""
    n = s.shape[0]
    if n % block or n <= block:
        return lower_bound_keys(s, q)
    nb = n // block
    top = s[::block]
    b_idx = ((top[None, :] < q[:, None]).sum(1) - 1).clamp(0, nb - 1)
    rows = s.reshape(nb, block)[b_idx]
    pos = b_idx * block + (rows < q[:, None]).sum(1)
    return pos.to(torch.int32)


def find(s_hi, s_lo, q_hi, q_lo, *, missing: int | None = None):
    """Index of each query key in the sorted table, or ``missing``
    (default N) when absent. Invalid-key queries never match."""
    n = s_hi.shape[0]
    if missing is None:
        missing = n
    pos = lower_bound(s_hi, s_lo, q_hi, q_lo).to(torch.int64)
    safe = pos.clamp(max=n - 1)
    found = (pos < n) & (s_hi[safe] == q_hi) & (s_lo[safe] == q_lo)
    valid_q = ~((q_hi == INVALID_KEY) & (q_lo == INVALID_KEY))
    return torch.where(found & valid_q, pos, missing).to(torch.int32)


def offset_delta(d) -> tuple[int, int]:
    """Packed-key delta (hi, lo) of a coordinate offset ``d = (dx, dy, dz)``:
    the key of ``coord + d`` is ``key + delta`` as a 64-bit add."""
    dx, dy, dz = (int(v) for v in d)
    return dx, dy * (1 << _Z_BITS) + dz


def shift_keys(hi, lo, d_hi: int, d_lo: int, mask=None):
    """Keys of ``coord + d``: a 64-bit (hi, lo) add with carry or borrow.

    Rows where ``mask`` is False get hi=0xFFFFFFFF, lo=0xFFFFFFFE, a key
    that matches nothing.
    """
    lo_u = to_u32(lo)
    q_lo = (lo_u + (d_lo & _U32)) & _U32
    if d_lo > 0:
        carry = (q_lo < lo_u).to(torch.int64)
    elif d_lo < 0:
        carry = -(q_lo > lo_u).to(torch.int64)
    else:
        carry = 0
    q_hi = to_i32(to_u32(hi) + (d_hi & _U32) + carry)
    q_lo = to_i32(q_lo)
    if mask is not None:
        q_hi = torch.where(mask, q_hi, INVALID_KEY)
        q_lo = torch.where(mask, q_lo, MASKED_LO)
    return q_hi, q_lo


def shifted_key64(hi, lo, valid, d_hi, d_lo):
    """``key64`` of each key ``(hi, lo)`` plus the 64-bit delta ``(d_hi,
    d_lo)`` (uint32 values in int64 tensors; all arguments broadcast).
    Rows where ``valid`` is False get the key of hi=0xFFFFFFFF,
    lo=0xFFFFFFFE, which matches nothing."""
    lo_u = to_u32(lo)
    q_lo = (lo_u + d_lo) & _U32
    q_hi = (to_u32(hi) + d_hi + (q_lo < lo_u).to(torch.int64)) & _U32
    q_hi = torch.where(valid, q_hi, _U32)
    q_lo = torch.where(valid, q_lo, MASKED_LO & _U32)
    return key64(q_hi, q_lo)


def unique_first_occurrence(s_hi, s_lo, s_valid):
    """Flags [N] marking the first row of each distinct valid key in a
    sorted key table."""
    # the first row is new; writing a tensor (not a Python scalar) into
    # the rest keeps the host from waiting on a copy to the card
    is_new = torch.ones_like(s_valid)
    is_new[1:] = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    return is_new & s_valid
