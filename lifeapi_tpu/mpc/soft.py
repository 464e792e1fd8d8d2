"""Differentiable soft-Life dynamics for trajectory optimization.

The MPC relaxation from the north star (BASELINE.json): the exact bitboard
update (B3/S23 over CSA counts) is relaxed to a smooth map on cell
probabilities so control sequences can be optimized by gradients / SQP,
while the *hard* binary path (core.step / ops.step_cuda, bit-exact vs the
reference) re-simulates and scores candidates.

Dynamics: p' = p * survive(count) + (1 - p) * birth(count), where count is
the expected live-neighbour count (3x3 sum minus center) and the gates are
sigmoid windows around [2, 3] and {3} that sharpen to the exact rule as the
temperature tau -> 0.  Controls are per-step cell toggle probabilities
applied as a smooth XOR.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def neighbour_sum(p):
    """Expected live neighbours (center excluded), float [..., 64, 64]."""
    v = p + jnp.roll(p, 1, axis=-1) + jnp.roll(p, -1, axis=-1)
    total = v + jnp.roll(v, 1, axis=-2) + jnp.roll(v, -1, axis=-2)
    return total - p


def soft_gates(count, tau):
    """(survive, birth) gate values for a neighbour count."""
    sig = jax.nn.sigmoid
    survive = sig((count - 1.5) / tau) * sig((3.5 - count) / tau)
    birth = sig((count - 2.5) / tau) * sig((3.5 - count) / tau)
    return survive, birth


def soft_step(p, tau=0.2):
    """One soft-Life generation on probabilities [..., 64, 64]."""
    count = neighbour_sum(p)
    survive, birth = soft_gates(count, tau)
    return p * survive + (1.0 - p) * birth


def soft_toggle(p, u):
    """Smooth XOR: toggle each cell with probability u."""
    return p * (1.0 - u) + (1.0 - p) * u


def soft_rollout(p0, controls, tau=0.2, remat=True):
    """Roll the horizon: at each step apply the control toggles, then the
    soft dynamics.  controls: [T, ..., 64, 64] toggle probabilities.
    Returns (final p, trajectory [T, ...])."""
    step_fn = soft_step

    def body(p, u):
        p = soft_toggle(p, u)
        p = step_fn(p, tau)
        return p, p

    if remat:
        body = jax.checkpoint(body)
    return jax.lax.scan(body, p0, controls)


def hard_rollout(board0, toggles, steps_per_control=1):
    """Exact binary counterpart on packed boards: XOR the binarized toggle
    mask, then the bit-exact step (reference Step semantics) — used to
    score candidates.  toggles: packed uint32 [T, ..., 64, 2]."""
    from ..core import step as S

    def body(b, t):
        b = b ^ t
        b = S.step(b)
        return b, None

    out, _ = jax.lax.scan(body, board0, toggles)
    return out


def binarize_controls(control_probs):
    """Toggle probabilities -> packed toggle masks (u > 0.5)."""
    from ..core import board as B

    return B.from_dense(control_probs > 0.5)
