"""64-bit unsigned arithmetic on (hi, lo) uint32 pairs.

JAX runs without 64-bit types unless x64 mode is enabled, so every u64
quantity in the SHIMMER pipeline (k-mer registers, Wang hashes, MM128
fields) is carried as two uint32 planes.  All ops are elementwise.
Whether native uint64 under x64 is as fast on the H100 is not yet
measured.

Bit-exactness against the reference's u64 semantics
(reference: pgr-db/src/shmmrutils.rs:271-280 for the hash) is enforced by
tests/test_ops_u64.py.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

U32 = jnp.uint32
_MASK32 = jnp.uint32(0xFFFFFFFF)

U64 = Tuple[jnp.ndarray, jnp.ndarray]  # (hi, lo)


def from_int(v: int, like=None) -> U64:
    hi = jnp.uint32((v >> 32) & 0xFFFFFFFF)
    lo = jnp.uint32(v & 0xFFFFFFFF)
    if like is not None:
        hi = jnp.full_like(like, hi, dtype=jnp.uint32)
        lo = jnp.full_like(like, lo, dtype=jnp.uint32)
    return hi, lo


def to_numpy(a: U64):
    """(hi, lo) -> numpy uint64 (host-side helper)."""
    import numpy as np

    hi, lo = a
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64
    )


def from_numpy(v):
    """numpy uint64 array -> (hi, lo) jnp uint32 arrays."""
    import numpy as np

    v = np.asarray(v, dtype=np.uint64)
    return (
        jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def add(a: U64, b: U64) -> U64:
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(U32)
    hi = a[0] + b[0] + carry
    return hi, lo


def xor(a: U64, b: U64) -> U64:
    return a[0] ^ b[0], a[1] ^ b[1]


def or_(a: U64, b: U64) -> U64:
    return a[0] | b[0], a[1] | b[1]


def and_(a: U64, b: U64) -> U64:
    return a[0] & b[0], a[1] & b[1]


def not_(a: U64) -> U64:
    return ~a[0], ~a[1]


def shl_const(a: U64, s: int) -> U64:
    """Shift left by a Python-constant amount in [0, 64)."""
    hi, lo = a
    if s == 0:
        return hi, lo
    if s < 32:
        return (hi << s) | (lo >> (32 - s)), lo << s
    return lo << (s - 32), jnp.zeros_like(lo)


def shr_const(a: U64, s: int) -> U64:
    hi, lo = a
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, (lo >> s) | (hi << (32 - s))
    return jnp.zeros_like(hi), hi >> (s - 32)


def shl(a: U64, s) -> U64:
    """Shift left by per-element uint32 amounts in [0, 64)."""
    hi, lo = a
    s = s.astype(U32)
    lt = s < 32
    s2 = jnp.where(lt, s, s - 32)
    inv = jnp.uint32(32) - s2
    # s2 in [0,32); inv in (0,32]; handle inv==32 (s2==0) via where
    hi_lt = (hi << s2) | jnp.where(s2 == 0, jnp.uint32(0), lo >> inv)
    lo_lt = lo << s2
    hi_ge = lo << s2
    return jnp.where(lt, hi_lt, hi_ge), jnp.where(lt, lo_lt, jnp.uint32(0))


def shr(a: U64, s) -> U64:
    hi, lo = a
    s = s.astype(U32)
    lt = s < 32
    s2 = jnp.where(lt, s, s - 32)
    inv = jnp.uint32(32) - s2
    lo_lt = (lo >> s2) | jnp.where(s2 == 0, jnp.uint32(0), hi << inv)
    hi_lt = hi >> s2
    lo_ge = hi >> s2
    return jnp.where(lt, hi_lt, jnp.uint32(0)), jnp.where(lt, lo_lt, lo_ge)


def eq(a: U64, b: U64):
    return (a[0] == b[0]) & (a[1] == b[1])


def lt(a: U64, b: U64):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def le(a: U64, b: U64):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def where(cond, a: U64, b: U64) -> U64:
    return jnp.where(cond, a[0], b[0]), jnp.where(cond, a[1], b[1])


def min_(a: U64, b: U64) -> U64:
    return where(lt(a, b), a, b)


def mask_const(a: U64, mask: int) -> U64:
    return a[0] & jnp.uint32((mask >> 32) & 0xFFFFFFFF), a[1] & jnp.uint32(
        mask & 0xFFFFFFFF
    )


def wang_hash(key: U64) -> U64:
    """Thomas Wang 64-bit hash, bit-exact vs the reference u64hash
    (reference: shmmrutils.rs:271-280)."""
    key = add(not_(key), shl_const(key, 21))
    key = xor(key, shr_const(key, 24))
    key = add(add(key, shl_const(key, 3)), shl_const(key, 8))
    key = xor(key, shr_const(key, 14))
    key = add(add(key, shl_const(key, 2)), shl_const(key, 4))
    key = xor(key, shr_const(key, 28))
    key = add(key, shl_const(key, 31))
    return key
