"""Receding-horizon MPC driver: solve, apply the first control slice on
the exact dynamics, re-solve from the new state.

The per-solve machinery is mpc/solver.py.  Two drivers:

* :func:`run` — host-side loop, one dispatch per solver stage; the
  debuggable variant.
* :func:`run_fused` — the production path: the ENTIRE receding loop
  (every replan round: gradient solve + bit-exact rescore + elite pick +
  apply-slice + warm-started logit shift) is one ``lax.scan`` inside one
  jitted dispatch, so the whole control loop stays on the device with no
  host round trip between rounds.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import board as B
from ..core import step as S
from ..target import hamming_cost
from . import soft as soft_mod
from . import solver as solver_mod


class MPCRun(NamedTuple):
    boards: jax.Array  # packed uint32[steps+1, 64, 2] visited states
    applied: jax.Array  # packed uint32[steps, 64, 2] applied toggles
    costs: jax.Array  # float[steps] hard cost of each solve


def run(problem, key, steps, apply_horizon=1, n_candidates=16,
        solve_iters=80, warm_start=True):
    """Drive the system ``steps`` generations, re-solving every
    ``apply_horizon`` applied control slices.  Returns the visited
    trajectory, applied controls and per-solve costs."""
    boards = [problem.initial]
    applied = []
    costs = []
    cur = problem
    logits = None
    t = 0
    while t < steps:
        key, sub = jax.random.split(key)
        if logits is None or not warm_start:
            logits = solver_mod.init_logits(sub, cur, n_candidates)
        lg, _ = solver_mod.solve_gradient(logits, cur, iters=solve_iters)
        sol = solver_mod.rescore_and_select(lg, cur)
        costs.append(float(sol.cost))

        n_apply = min(apply_horizon, cur.horizon, steps - t)
        board = boards[-1]
        for i in range(n_apply):
            toggle = sol.controls[i]
            board = S.step(board ^ toggle)
            applied.append(toggle)
            boards.append(board)
        t += n_apply

        remaining = cur.horizon  # keep a constant lookahead window
        cur = cur._replace(initial=board)
        if warm_start:
            # shift the candidate controls by the applied steps; pad with
            # fresh noise at the tail
            key, sub = jax.random.split(key)
            tail = solver_mod.init_logits(sub, cur, lg.shape[0])[:, :n_apply]
            logits = jnp.concatenate([lg[:, n_apply:], tail], axis=1)

    return MPCRun(
        jnp.stack(boards), jnp.stack(applied) if applied else
        jnp.zeros((0, 64, 2), jnp.uint32), jnp.asarray(costs)
    )


def final_error(run_result: MPCRun, target):
    return hamming_cost(run_result.boards[-1], target)


def run_fused(problem, key, steps, apply_horizon=1, n_candidates=16,
              solve_iters=80):
    """One-dispatch receding-horizon drive (always warm-started).

    ``steps`` must be a multiple of ``apply_horizon``; the scan runs
    ``steps // apply_horizon`` replan rounds.  Each round, in-graph:

    1. gradient solve from the current board (``solver.solve_gradient``'s
       body, scanned over ``solve_iters``),
    2. binarize every candidate, bit-exact rollout, integer-cost elite
       pick (``rescore_and_select`` semantics),
    3. apply the elite's first ``apply_horizon`` toggle slices on the
       exact dynamics,
    4. shift the candidate logits by the applied steps and refresh the
       tail with noise (warm start).

    Returns an :class:`MPCRun` (boards ``[steps+1]``, applied toggles
    ``[steps]``, per-round elite costs ``[rounds]``).
    """
    if steps % apply_horizon != 0:
        raise ValueError("steps must be a multiple of apply_horizon")
    logits0 = solver_mod.init_logits(key, problem, n_candidates)
    return _run_fused(problem, key, logits0, steps=steps,
                      apply_horizon=apply_horizon, solve_iters=solve_iters)


@functools.partial(
    jax.jit, static_argnames=("steps", "apply_horizon", "solve_iters")
)
def _run_fused(problem, key, logits0, *, steps, apply_horizon, solve_iters):
    rounds = steps // apply_horizon
    A = apply_horizon
    n_candidates = logits0.shape[0]

    def replan(carry, key_i):
        board, logits = carry
        cur = problem._replace(initial=board)

        lg, _ = solver_mod.solve_gradient.__wrapped__(
            logits, cur, iters=solve_iters
        )

        # hard rescore + elite pick (rescore_and_select, in-graph)
        probs = jax.nn.sigmoid(lg) * cur.control_mask
        costs, _ = jax.vmap(lambda p: solver_mod.hard_score(p, cur))(probs)
        best = jnp.argmin(costs)
        toggles = soft_mod.binarize_controls(probs[best])  # [T, 64, 2]

        # apply the first A slices on the exact dynamics
        def apply_one(b, tog):
            nb = S.step(b ^ tog)
            return nb, nb

        board, visited = jax.lax.scan(apply_one, board, toggles[:A])

        # warm start: shift by A, fresh noise on the tail (same
        # distribution as init_logits, static [*, A, 64, 64] shape)
        tail = -3.0 + 0.5 * jax.random.normal(
            key_i, (n_candidates, A, 64, 64), jnp.float32
        )
        logits = jnp.concatenate([lg[:, A:], tail], axis=1)

        return (board, logits), (visited, toggles[:A], costs[best])

    keys = jax.random.split(key, rounds)
    (_, _), (visited, applied, costs) = jax.lax.scan(
        replan, (problem.initial, logits0), keys
    )
    boards = jnp.concatenate(
        [problem.initial[None], visited.reshape(steps, 64, 2)]
    )
    return MPCRun(boards, applied.reshape(steps, 64, 2), costs)
