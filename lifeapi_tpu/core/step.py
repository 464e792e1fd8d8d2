"""Life stepping and neighbour counting on packed boards.

Batched counterpart of the reference's hottest path (reference
LifeAPI.hpp:822-1064, :1196-1254 and NeighbourCount.hpp).  The same
carry-save-adder structure is kept so the binary path is bit-exact by
construction: per-column vertical 3-sums in two bit-planes, then a 1D
stencil over columns.  The update formula on the hot path is Rokicki's
algebraic next-state formula (publicly described in his G4G13 "Life
Algorithms" paper, cited by the reference at LifeAPI.hpp:835-836).

Everything here operates on packed ``uint32[..., 64, 2]`` boards and is
batched/jit/vmap friendly.  This module is the portable implementation
that XLA compiles for any backend, the reference the fused CUDA kernels
(:mod:`lifeapi_tpu.ops.step_cuda`) are tested against, and the building
block for neighbour-count based analyses.  :func:`rollout` is the public
multi-generation entry point and picks the engine per platform.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .board import roll_x, roll_y


def half_add(a, b):
    """(sum, carry) one-bit adder on boards (reference LifeAPI.hpp:850-854)."""
    return a ^ b, a & b


def full_add(a, b, c):
    """(sum, carry) full adder on boards (reference LifeAPI.hpp:856-864)."""
    half = a ^ b
    return half ^ c, (a & b) | (c & half)


def count_rows(board):
    """Vertical (within-column) 3-sum of each cell and its y-neighbours, as
    two bit-planes (bit0, bit1) (reference ``CountRows``,
    LifeAPI.hpp:897-907)."""
    l = roll_y(board, 1)
    r = roll_y(board, -1)
    bit0 = l ^ r ^ board
    bit1 = ((l ^ r) & board) | (l & r)
    return bit0, bit1


def step(board):
    """One Life generation on the 64x64 torus, bit-exact with the reference
    ``Step`` (LifeAPI.hpp:1196-1216, Rokicki formula at :837-848)."""
    col0, col1 = count_rows(board)
    u0 = roll_x(col0, 1)
    u1 = roll_x(col1, 1)
    b0 = roll_x(col0, -1)
    b1 = roll_x(col1, -1)

    a = board
    aw = roll_y(a, 1)
    ae = roll_y(a, -1)
    s0 = aw ^ ae
    s1 = aw & ae
    ts0 = b0 ^ u0
    ts1 = (b0 & u0) | (ts0 & s0)
    return (b1 ^ u1 ^ ts1 ^ s1) & ((b1 | u1) ^ (ts1 | s1)) & ((ts0 ^ s0) | a)


def step_alt(board):
    """Independent derivation of the Life step used as a differential-test
    oracle (reference ``StepAlt``, LifeAPI.hpp:1218-1254): two full adds of
    the vertical sums followed by explicit B3/S23 selection."""
    col0, col1 = count_rows(board)
    u0 = roll_x(col0, 1)
    u1 = roll_x(col1, 1)
    l0 = roll_x(col0, -1)
    l1 = roll_x(col1, -1)

    final_sum, final_carry = full_add(u0, col0, l0)
    carry_sum, carry_carry = full_add(u1, col1, l1)
    carry_carry = carry_carry ^ (final_carry & carry_sum)
    return (
        (final_sum ^ carry_carry)
        & (final_carry ^ carry_sum ^ carry_carry)
        & (board | final_sum)
    )


@partial(jax.jit, static_argnames=("n", "unroll"))
def step_n(board, n, unroll=4):
    """n Life generations via ``lax.scan`` (reference ``Step(numIters)``,
    LifeAPI.hpp:877-881).  Horizon stays on-chip; no host round-trips."""

    def body(b, _):
        return step(b), None

    out, _ = jax.lax.scan(body, board, None, length=n, unroll=unroll)
    return out


def rollout(boards, steps, engine=None):
    """Advance packed boards ``uint32[..., 64, 2]`` by ``steps``
    generations, bit-exact with :func:`step`.  ``engine`` (see
    lifeapi_tpu.platform): ``"cuda"`` runs the fused kernel that keeps
    each board in registers for the whole horizon (ops/step_cuda),
    ``"xla"`` runs :func:`step_n`, ``None`` picks the platform's engine."""
    from .. import platform

    if platform.step_engine(engine) == platform.CUDA:
        from ..ops import step_cuda

        return step_cuda.rollout(boards, steps)
    return step_n(boards, steps)


def step_eo(e, o):
    """One generation in even/odd packing (core.bitops.interleave_split):
    ``e``/``o`` are uint32[..., 64] column words holding the even / odd
    rows.  Same CSA/Rokicki netlist as :func:`step`, but the +-1 row
    rotate of a 64-bit column is one 32-bit rotate plus a word swap.  The
    plain-XLA form of the fused kernels' per-generation work."""
    re = (o << 1) | (o >> 31)  # rows y-1 of the even words
    rr = (e >> 1) | (e << 31)  # rows y+1 of the odd words
    x_e, x_o = re ^ o, e ^ rr
    u_e, u_o = re & o, e & rr
    c0_e, c0_o = x_e ^ e, x_o ^ o
    c1_e, c1_o = (x_e & e) | u_e, (x_o & o) | u_o

    def rok(a, s0, s1, c0, c1):
        u0, u1 = jnp.roll(c0, 1, axis=-1), jnp.roll(c1, 1, axis=-1)
        b0, b1 = jnp.roll(c0, -1, axis=-1), jnp.roll(c1, -1, axis=-1)
        ts0 = b0 ^ u0
        ts1 = (b0 & u0) | (ts0 & s0)
        return (b1 ^ u1 ^ ts1 ^ s1) & ((b1 | u1) ^ (ts1 | s1)) & ((ts0 ^ s0) | a)

    return rok(e, x_e, u_e, c0_e, c1_e), rok(o, x_o, u_o, c0_o, c1_o)


def stepped_trajectory(board, n):
    """The full horizon [n, ...board] of successive states, via scan."""

    def body(b, _):
        nb = step(b)
        return nb, nb

    _, traj = jax.lax.scan(body, board, None, length=n)
    return traj


def neighbour_counts(board):
    """Per-cell 9-cell window population (center INCLUDED) as four packed
    bit-planes (bit3, bit2, bit1, bit0) (reference ``CountNeighbourhood``,
    LifeAPI.hpp:909-952 and NeighbourCount.hpp:40-70)."""
    col0, col1 = count_rows(board)
    u0 = roll_x(col0, 1)
    u1 = roll_x(col1, 1)
    l0 = roll_x(col0, -1)
    l1 = roll_x(col1, -1)

    uc0, uc_carry0 = half_add(u0, col0)
    uc1, uc2 = full_add(u1, col1, uc_carry0)

    on0, on_carry0 = half_add(uc0, l0)
    on1, on_carry1 = full_add(uc1, l1, on_carry0)
    on2, on3 = half_add(uc2, on_carry1)
    return on3, on2, on1, on0


def count_planes_to_int(bit3, bit2, bit1, bit0):
    """Packed count planes -> dense int32[..., 64, 64] counts."""
    from .board import to_dense

    return (
        to_dense(bit3).astype(jnp.int32) * 8
        + to_dense(bit2).astype(jnp.int32) * 4
        + to_dense(bit1).astype(jnp.int32) * 2
        + to_dense(bit0).astype(jnp.int32)
    )


def with_exactly(planes, n):
    """Mask of cells whose 4-bit count equals n (reference
    ``NeighbourCount::WithExactly``, NeighbourCount.hpp:93-102)."""
    bit3, bit2, bit1, bit0 = planes
    result = ~jnp.zeros_like(bit0)
    result &= bit0 if (n & 1) else ~bit0
    result &= bit1 if (n & 2) else ~bit1
    result &= bit2 if (n & 4) else ~bit2
    result &= bit3 if (n & 8) else ~bit3
    return result


def add_counts(a_planes, b_planes, carry=None):
    """Ripple add of two 4-bit count plane sets (reference
    ``NeighbourCount::Add``, NeighbourCount.hpp:71-79).  Planes are given
    (bit3, bit2, bit1, bit0) as produced by :func:`neighbour_counts`."""
    a3, a2, a1, a0 = a_planes
    b3, b2, b1, b0 = b_planes
    if carry is None:
        carry = jnp.zeros_like(a0)
    r0, carry = full_add(a0, b0, carry)
    r1, carry = full_add(a1, b1, carry)
    r2, carry = full_add(a2, b2, carry)
    r3, carry = full_add(a3, b3, carry)
    return r3, r2, r1, r0


def subtract_counts(a_planes, b_planes):
    """Reference ``NeighbourCount::Subtract`` (NeighbourCount.hpp:85-91):
    add the complement with carry-in ~0."""
    b3, b2, b1, b0 = b_planes
    ones = ~jnp.zeros_like(b0)
    return add_counts(a_planes, (~b3, ~b2, ~b1, ~b0), carry=ones)


def interaction_counts(board):
    """(out1, out2, out_more): OFF cells with exactly 1, exactly 2, or >= 3
    live neighbours (reference ``InteractionCounts``, LifeAPI.hpp:956-993)."""
    out1, out2, out_more, _ = _interaction_counts_impl(board, with_next=False)
    return out1, out2, out_more


def interaction_counts_and_next(board):
    """Fused variant also returning the next generation (reference
    ``InteractionCountsAndNext``, LifeAPI.hpp:997-1040)."""
    return _interaction_counts_impl(board, with_next=True)


def _interaction_counts_impl(board, with_next):
    col0, col1 = count_rows(board)
    u0 = roll_x(col0, 1)
    u1 = roll_x(col1, 1)
    l0 = roll_x(col0, -1)
    l1 = roll_x(col1, -1)

    final_sum, final_carry = full_add(u0, col0, l0)
    carry_sum, carry_carry = full_add(u1, col1, l1)

    off = ~board
    out1 = off & ~carry_carry & final_sum & ~carry_sum & ~final_carry
    out2 = off & ~carry_carry & ~final_sum & (carry_sum ^ final_carry)
    out_more = off & ~out2 & (final_carry | carry_sum | carry_carry)

    nxt = None
    if with_next:
        cc = carry_carry ^ (carry_sum & final_carry)
        nxt = (
            (final_sum ^ cc)
            & (final_carry ^ carry_sum ^ cc)
            & (board | final_sum)
        )
    return out1, out2, out_more, nxt


def step_for_cell(board, x, y):
    """Scalar next-state of one cell (reference ``StepFor``,
    LifeAPI.hpp:889-895)."""
    from .board import get_cell

    planes = neighbour_counts(board)
    count_inc = count_planes_to_int(*planes)[..., x, y]
    center = get_cell(board, x, y)
    count = count_inc - center.astype(jnp.int32)
    return jnp.where(center, (count == 2) | (count == 3), count == 3)
