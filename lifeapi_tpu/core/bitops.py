"""Word-level bit tricks on 32-bit words.

Batched counterparts of the reference's ``Bits.hpp`` (reference:
Bits.hpp:10-143).  A 64-bit column is represented as a pair of uint32 words
``(lo, hi)`` where ``lo`` holds bits y=0..31 and ``hi`` holds bits y=32..63.
All functions are elementwise over arbitrary leading batch dims and are
jit/vmap friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U32 = jnp.uint32

_MASKS32 = (
    0x55555555,
    0x33333333,
    0x0F0F0F0F,
    0x00FF00FF,
    0x0000FFFF,
)


def bitrev32(x):
    """Reverse the bits of each uint32 lane (cf. reference Bits.hpp:10-23)."""
    x = x.astype(U32)
    for i, m in enumerate(_MASKS32):
        s = 1 << i
        m = U32(m)
        x = ((x >> s) & m) | ((x & m) << s)
    return x


def funnel(a, b, r):
    """(a << r) | (b >> (32 - r)) with r in [0, 32), safe at r == 0.

    This is the 32-bit funnel shift used to emulate 64-bit rotates.
    ``r`` may be a traced scalar.
    """
    a = a.astype(U32)
    b = b.astype(U32)
    if isinstance(r, int):
        if r == 0:
            return a
        return (a << r) | (b >> (32 - r))
    r = jnp.asarray(r, dtype=U32)
    hi = a << r
    lo = jnp.where(r == 0, U32(0), b >> (U32(32) - r))
    return hi | lo


def rotl64(lo, hi, k):
    """Rotate the 64-bit value (lo, hi) left (towards higher y) by k.

    Counterpart of ``std::rotl(column, k)`` in the reference (used all over
    LifeAPI.hpp, e.g. :525, :840).  Returns ``(lo, hi)``.  ``k`` may be a
    Python int (specialized at trace time) or a traced scalar.
    """
    if isinstance(k, int):
        k %= 64
        if k >= 32:
            lo, hi = hi, lo
            k -= 32
        if k == 0:
            return lo, hi
        return funnel(lo, hi, k), funnel(hi, lo, k)
    k = jnp.asarray(k) % 64
    swap = (k // 32) == 1
    r = k % 32
    lo_, hi_ = (
        jnp.where(swap, hi, lo),
        jnp.where(swap, lo, hi),
    )
    return funnel(lo_, hi_, r), funnel(hi_, lo_, r)


def rotr64(lo, hi, k):
    """Rotate the 64-bit value (lo, hi) right by k."""
    if isinstance(k, int):
        return rotl64(lo, hi, (-k) % 64)
    return rotl64(lo, hi, (64 - (jnp.asarray(k) % 64)) % 64)


def popcount64(lo, hi):
    """Population count of the 64-bit pair, as int32."""
    return (
        jax.lax.population_count(lo.astype(U32)).astype(jnp.int32)
        + jax.lax.population_count(hi.astype(U32)).astype(jnp.int32)
    )


def reverse64(lo, hi):
    """Bit-reverse of the 64-bit value: bit y -> bit 63-y.

    Counterpart of ``__builtin_bitreverse64`` (reference LifeAPI.hpp:758-762).
    """
    return bitrev32(hi), bitrev32(lo)


# ---------------------------------------------------------------------------
# Circular-run queries (reference Bits.hpp:29-130).  These operate on a
# 64-bit pair and return small int32 results; they are used by bounding-box
# style queries which are not hot paths, so clarity over cleverness.
# ---------------------------------------------------------------------------


def _compress_even(x):
    """Gather the even-indexed bits of a uint32 into its low 16 bits
    (Morton decode step)."""
    x = x & U32(0x55555555)
    x = (x | (x >> 1)) & U32(0x33333333)
    x = (x | (x >> 2)) & U32(0x0F0F0F0F)
    x = (x | (x >> 4)) & U32(0x00FF00FF)
    x = (x | (x >> 8)) & U32(0x0000FFFF)
    return x


def _expand_even(x):
    """Inverse of _compress_even: scatter low 16 bits to even positions."""
    x = x & U32(0x0000FFFF)
    x = (x | (x << 8)) & U32(0x00FF00FF)
    x = (x | (x << 4)) & U32(0x0F0F0F0F)
    x = (x | (x << 2)) & U32(0x33333333)
    x = (x | (x << 1)) & U32(0x55555555)
    return x


def interleave_split(lo, hi):
    """(lo, hi) 64-bit column pair -> (even, odd) half-words: ``even`` holds
    bits y = 0,2,..,62 (bit k = y=2k), ``odd`` holds y = 1,3,..,63.

    In this packing a 64-bit rotate by +-1 costs ONE 32-bit rotate plus a
    free word swap (vs. two funnel shifts), which is what makes the fused
    step kernels' hot path cheaper (ops/step_kernels.cu, core.step.step_eo)."""
    lo = lo.astype(U32)
    hi = hi.astype(U32)
    e = _compress_even(lo) | (_compress_even(hi) << 16)
    o = _compress_even(lo >> 1) | (_compress_even(hi >> 1) << 16)
    return e, o


def interleave_merge(e, o):
    """Inverse of interleave_split."""
    e = e.astype(U32)
    o = o.astype(U32)
    lo = _expand_even(e & U32(0xFFFF)) | (_expand_even(o & U32(0xFFFF)) << 1)
    hi = _expand_even(e >> 16) | (_expand_even(o >> 16) << 1)
    return lo, hi


def _bit(lo, hi, y):
    """Extract bit y (0..63) of the pair as uint32 0/1; y may be traced."""
    y = jnp.asarray(y)
    word = jnp.where(y < 32, lo, hi)
    return (word >> (y % 32)) & U32(1)


def longest_run64(lo, hi):
    """Length of the longest *circular* run of 1 bits (Bits.hpp:29-62).

    Implemented by the same log-step rotate-and-AND scheme as the reference,
    but on the 32-bit pair representation.
    """
    lo = lo.astype(U32)
    hi = hi.astype(U32)
    is_zero = (lo | hi) == 0
    is_full = (lo & hi) == U32(0xFFFFFFFF)

    # pow2runs[n]: x AND-ed with itself rotated by 1, 2, 4, ... 32.
    xs_lo, xs_hi = [lo], [hi]
    x_lo, x_hi = lo, hi
    for n in range(6):
        r_lo, r_hi = rotl64(x_lo, x_hi, 1 << n)
        x_lo = x_lo & r_lo
        x_hi = x_hi & r_hi
        xs_lo.append(x_lo)
        xs_hi.append(x_hi)

    # last = largest n with pow2runs[n] != 0 (the reference breaks at the
    # first zero; runs are monotone so these agree).
    nz = jnp.stack([(l | h) != 0 for l, h in zip(xs_lo[:6], xs_hi[:6])])
    last = jnp.sum(nz.astype(jnp.int32), axis=0) - 1
    last = jnp.clip(last, 0, 5)

    def gather(stacked, idx):
        return jnp.take_along_axis(stacked, idx[None].astype(jnp.int32), axis=0)[0]

    sl = jnp.stack(xs_lo[:6])
    sh = jnp.stack(xs_hi[:6])
    x_lo = gather(sl, last)
    x_hi = gather(sh, last)
    count = (1 << last).astype(jnp.int32)

    for n in range(5, -1, -1):
        r_lo, r_hi = rotl64(x_lo, x_hi, 1 << n)
        y_lo = x_lo & r_lo
        y_hi = x_hi & r_hi
        ok = ((y_lo | y_hi) != 0) & (n < last)
        count = jnp.where(ok, count + (1 << n), count)
        x_lo = jnp.where(ok, y_lo, x_lo)
        x_hi = jnp.where(ok, y_hi, x_hi)

    return jnp.where(is_zero, 0, jnp.where(is_full, 64, count))


def populated_width64(lo, hi):
    """Width of the smallest circular window containing all set bits
    (Bits.hpp:64-79): 64 - longest circular run of zeros, 0 for empty."""
    is_zero = (lo.astype(U32) | hi.astype(U32)) == 0
    return jnp.where(is_zero, 0, 64 - longest_run64(~lo, ~hi))


def convolve_word64(x_lo, x_hi, y_lo, y_hi):
    """OR-convolution of two 64-bit words: bit k of the result is set iff
    there are set bits i in x and j in y with i + j == k (mod 64)
    (Bits.hpp:132-143).  Dense formulation: OR over all 64 rotations of y
    gated by the bits of x.
    """
    out_lo = jnp.zeros_like(x_lo, dtype=U32)
    out_hi = jnp.zeros_like(x_hi, dtype=U32)
    for k in range(64):
        bit = _bit(x_lo, x_hi, k)
        mask = jnp.where(bit != 0, U32(0xFFFFFFFF), U32(0))
        r_lo, r_hi = rotl64(y_lo, y_hi, k)
        out_lo = out_lo | (r_lo & mask)
        out_hi = out_hi | (r_hi & mask)
    return out_lo, out_hi
