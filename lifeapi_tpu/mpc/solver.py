"""MPC / trajectory-optimization engine over Life dynamics.

Solves: find per-step cell-toggle controls (restricted to a control mask)
that steer the 64x64 torus from an initial board to a LifeTarget at the
horizon, optionally preserving a protected still-life background, under a
control-effort penalty (north star, BASELINE.json).

Three in-graph optimizers over the soft-Life relaxation (mpc/soft.py):

* :func:`solve_gradient` — batched first-order (adam) on control logits
  with temperature annealing; the workhorse.
* :func:`solve_sqp` — sequential quadratic steps: damped Newton where each
  QP block (H + lam I) d = -g is solved by conjugate gradients in-graph,
  with Hessian-vector products from double-backward autodiff.
* :func:`solve_cem` — derivative-free cross-entropy method scoring
  candidates on the EXACT bit-parallel path only.

Every solver finishes with hard re-simulation (bit-exact Step) and elite
selection, so reported costs are true integer Hamming costs, never relaxed
ones.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from .. import platform
from ..core import board as B
from ..target import LifeTarget
from . import cost as cost_mod
from . import soft as soft_mod


class MPCProblem(NamedTuple):
    initial: jax.Array  # packed uint32[64, 2]
    target: LifeTarget
    horizon: int
    control_mask: jax.Array  # dense bool[64, 64] of allowed toggle cells
    protected: Optional[jax.Array] = None  # dense bool[64, 64]
    background: Optional[jax.Array] = None  # packed, intended protected state
    weights: cost_mod.CostWeights = cost_mod.CostWeights()
    tau: float = 0.25


class MPCSolution(NamedTuple):
    controls: jax.Array  # packed toggles uint32[T, 64, 2] of the best candidate
    control_probs: jax.Array  # [T, 64, 64] relaxed controls of the best
    final_board: jax.Array  # packed board after hard rollout
    cost: jax.Array  # hard cost of the best candidate
    all_costs: jax.Array  # [C] hard costs of every candidate


def _soft_initial(problem: MPCProblem):
    return B.to_dense(problem.initial).astype(jnp.float32)


def soft_objective(logits, problem: MPCProblem, tau=None):
    """Relaxed cost of one candidate's control logits [T, 64, 64]."""
    tau = problem.tau if tau is None else tau
    mask = problem.control_mask.astype(jnp.float32)
    controls = jax.nn.sigmoid(logits) * mask
    p0 = _soft_initial(problem)
    p_final, traj = soft_mod.soft_rollout(p0, controls, tau=tau)
    return cost_mod.soft_total(
        p_final, traj, controls, problem.target, problem.protected,
        problem.weights,
    )


def hard_score(control_probs, problem: MPCProblem):
    """Exact cost of binarized controls.  control_probs: [T, 64, 64]."""
    mask = problem.control_mask
    toggles = soft_mod.binarize_controls(control_probs * mask)
    final = soft_mod.hard_rollout(problem.initial, toggles)
    return (
        cost_mod.hard_total(
            final, toggles, problem.target,
            None if problem.protected is None else B.from_dense(problem.protected),
            problem.background if problem.background is not None else problem.initial,
            problem.weights,
        ),
        final,
    )


def hard_score_batch(control_probs, problem: MPCProblem, use_fused=None):
    """Exact costs of a batch of binarized control candidates
    [C, T, 64, 64].  ``use_fused=True`` routes the rollouts through the
    fused CUDA controlled-rollout kernel (ops/step_cuda), ``False``
    through the XLA scan, ``None`` by the platform (lifeapi_tpu.platform);
    both are bit-exact."""
    mask = problem.control_mask
    toggles = soft_mod.binarize_controls(control_probs * mask)  # [C,T,64,2]
    C = toggles.shape[0]
    engine = None if use_fused is None else (
        platform.CUDA if use_fused else platform.XLA)
    if platform.step_engine(engine) == platform.CUDA:
        from ..ops import step_cuda

        boards = jnp.broadcast_to(problem.initial, (C, 64, 2))
        toggles_tb = jnp.swapaxes(toggles, 0, 1)  # [T, C, 64, 2]
        finals = step_cuda.controlled_rollout(boards, toggles_tb)
    else:
        finals = jax.vmap(
            lambda t: soft_mod.hard_rollout(problem.initial, t)
        )(toggles)
    protected = (
        None if problem.protected is None else B.from_dense(problem.protected)
    )
    background = (
        problem.background if problem.background is not None else problem.initial
    )
    costs = jax.vmap(
        lambda f, t: cost_mod.hard_total(
            f, t, problem.target, protected, background, problem.weights
        )
    )(finals, toggles)
    return costs, finals


def init_logits(key, problem: MPCProblem, n_candidates, scale=0.5, bias=-3.0):
    T = problem.horizon
    return bias + scale * jax.random.normal(
        key, (n_candidates, T, 64, 64), dtype=jnp.float32
    )


@functools.partial(jax.jit, static_argnames=("iters",))
def solve_gradient(logits0, problem: MPCProblem, iters=150, lr=0.15,
                   tau_start=0.6, tau_end=0.15):
    """First-order batched solve.  logits0: [C, T, 64, 64]."""
    opt = optax.adam(lr)

    def one_cost(logits, tau):
        return soft_objective(logits, problem, tau)

    batched_grad = jax.vmap(jax.value_and_grad(one_cost), in_axes=(0, None))

    def step(carry, i):
        logits, opt_state = carry
        frac = i / max(iters - 1, 1)
        tau = tau_start * (tau_end / tau_start) ** frac
        vals, grads = batched_grad(logits, tau)
        updates, opt_state = opt.update(grads, opt_state)
        logits = optax.apply_updates(logits, updates)
        return (logits, opt_state), vals

    (logits, _), history = jax.lax.scan(
        step, (logits0, opt.init(logits0)), jnp.arange(iters)
    )
    return logits, history


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters"))
def solve_sqp(logits0, problem: MPCProblem, iters=8, cg_iters=12,
              damping=1.0):
    """Damped Newton / SQP on the relaxed objective: each step solves the
    QP block (H + lam I) d = -g by CG, H-vector products by double-backward
    autodiff — all in-graph (north-star 'QP/SQP blocks solved in-graph').

    logits0: [C, T, 64, 64]; each candidate solved independently (vmap)."""

    def one_solve(logits):
        def f(lg):
            return soft_objective(lg, problem)

        def newton_step(lg, lam):
            g = jax.grad(f)(lg)

            def hvp(v):
                return jax.jvp(jax.grad(f), (lg,), (v,))[1] + lam * v

            d, _ = jax.scipy.sparse.linalg.cg(hvp, -g, maxiter=cg_iters)
            # backtracking: accept the best of a few step sizes
            cands = jnp.stack([lg + a * d for a in (1.0, 0.5, 0.25)])
            costs = jax.vmap(f)(cands)
            best = jnp.argmin(costs)
            improved = costs[best] < f(lg)
            return jnp.where(improved, cands[best], lg)

        def body(lg, i):
            lam = damping * (0.5 ** i.astype(jnp.float32))
            return newton_step(lg, lam), None

        out, _ = jax.lax.scan(body, logits, jnp.arange(iters))
        return out

    return jax.vmap(one_solve)(logits0)


def rescore_and_select(logits, problem: MPCProblem):
    """Binarize every candidate, hard-simulate, pick the elite."""
    probs = jax.nn.sigmoid(logits) * problem.control_mask
    costs, finals = jax.vmap(lambda p: hard_score(p, problem))(probs)
    best = jnp.argmin(costs)
    toggles = soft_mod.binarize_controls(probs[best])
    return MPCSolution(
        controls=toggles,
        control_probs=probs[best],
        final_board=finals[best],
        cost=costs[best],
        all_costs=costs,
    )


def solve(problem: MPCProblem, key, n_candidates=32, method="gradient",
          iters=150, **kwargs):
    """End-to-end single-host solve: init -> optimize -> hard rescore."""
    logits0 = init_logits(key, problem, n_candidates)
    if method == "gradient":
        logits, _ = solve_gradient(logits0, problem, iters=iters, **kwargs)
    elif method == "sqp":
        logits, _ = solve_gradient(logits0, problem, iters=max(iters // 3, 10))
        logits = solve_sqp(logits, problem, **kwargs)
    else:
        raise ValueError(method)
    return rescore_and_select(logits, problem)


def solve_cem(problem: MPCProblem, key, pop=256, iters=20, elites=16,
              init_p=0.03, smoothing=0.7, mean0=None, use_fused=None):
    """Cross-entropy method on the exact path: sample toggle masks, score
    with the bit-exact rollout, refit toggle probabilities to the elite
    set.  ``mean0`` seeds the sampling distribution (e.g. from a gradient
    solve, the usual hybrid).  Returns (mean_probs [T, 64, 64], best_cost,
    best_controls, history)."""
    T = problem.horizon
    mask = problem.control_mask

    def score_batch(samples):
        costs, _ = hard_score_batch(
            samples.astype(jnp.float32), problem, use_fused=use_fused
        )
        return costs

    def body(carry, key_i):
        mean, best_cost, best_sample = carry
        samples = (
            jax.random.uniform(key_i, (pop, T, 64, 64)) < mean
        ) & mask
        costs = score_batch(samples)
        order = jnp.argsort(costs)
        elite_idx = order[:elites]
        elite = samples[elite_idx].astype(jnp.float32)
        new_mean = smoothing * mean + (1 - smoothing) * elite.mean(axis=0)
        new_mean = jnp.clip(new_mean, 1e-4, 1 - 1e-4)
        run_best = costs[order[0]]
        better = run_best < best_cost
        best_cost = jnp.where(better, run_best, best_cost)
        best_sample = jnp.where(better, samples[order[0]], best_sample)
        return (new_mean, best_cost, best_sample), run_best

    if mean0 is None:
        mean0 = jnp.full((T, 64, 64), init_p) * mask
    else:
        mean0 = jnp.clip(mean0 * mask, 1e-4, 1 - 1e-4)
    best0 = jnp.zeros((T, 64, 64), bool)
    keys = jax.random.split(key, iters)
    (mean, best_cost, best_sample), history = jax.lax.scan(
        body, (mean0, jnp.inf, best0), keys
    )
    return mean, best_cost, best_sample, history
