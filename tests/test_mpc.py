import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lifeapi_tpu.core import board, rle, step
from lifeapi_tpu.mpc import CostWeights, MPCProblem, soft, solver
from lifeapi_tpu.target import LifeTarget, hamming_cost

N = 64


def _glider():
    return board.move(rle.parse("bob$2bo$3o!"), 28, 28)


def test_soft_step_tracks_hard_step_at_low_tau():
    g = _glider()
    p = board.to_dense(g).astype(jnp.float32)
    hard = g
    for _ in range(8):
        p = soft.soft_step(p, tau=0.05)
        hard = step.step(hard)
    got = np.asarray(p > 0.5)
    expect = np.asarray(board.to_dense(hard))
    assert (got == expect).all()


def test_hard_rollout_with_toggles():
    g = _glider()
    T = 4
    toggles = jnp.zeros((T, 64, 2), jnp.uint32)
    out = soft.hard_rollout(g, toggles)
    assert bool(board.equal(out, step.step_n(g, T)))
    # toggling the whole glider off at step 0 leaves an empty board
    toggles = toggles.at[0].set(g)
    out = soft.hard_rollout(g, toggles)
    assert bool(board.is_empty(out))


def _toy_problem(horizon=6):
    # steer an empty board to contain a block at the horizon
    target_state = board.move(rle.parse("2o$2o!"), 31, 31)
    target = LifeTarget.from_state(target_state)
    mask = jnp.zeros((N, N), bool).at[24:40, 24:40].set(True)
    return MPCProblem(
        initial=board.empty(),
        target=target,
        horizon=horizon,
        control_mask=mask,
        weights=CostWeights(target=1.0, control=0.01),
    )


def test_gradient_solver_reaches_target():
    problem = _toy_problem()
    key = jax.random.key(0)
    sol = solver.solve(problem, key, n_candidates=8, iters=120)
    # cost = hamming + small control effort; reaching the block exactly
    # means hamming contribution 0
    ham = hamming_cost(sol.final_board, problem.target)
    assert int(ham) == 0, int(ham)


def test_cem_solver_reaches_target():
    # CEM with a focused control mask (derivative-free refinement layer;
    # in production it is seeded from a gradient solve via mean0)
    target_state = board.move(rle.parse("2o$2o!"), 31, 31)
    target = LifeTarget.from_state(target_state)
    mask = jnp.zeros((N, N), bool).at[30:34, 30:34].set(True)
    problem = MPCProblem(
        initial=board.empty(), target=target, horizon=2, control_mask=mask,
        weights=CostWeights(target=1.0, control=0.01),
    )
    key = jax.random.key(1)
    mean, best_cost, best_sample, history = solver.solve_cem(
        problem, key, pop=128, iters=12, elites=8, init_p=0.25
    )
    toggles = soft.binarize_controls(best_sample.astype(jnp.float32))
    final = soft.hard_rollout(problem.initial, toggles)
    assert int(hamming_cost(final, problem.target)) == 0


def test_cem_seeded_from_gradient():
    problem = _toy_problem(horizon=4)
    key = jax.random.key(7)
    sol = solver.solve(problem, key, n_candidates=8, iters=100)
    mean, best_cost, best_sample, _ = solver.solve_cem(
        problem, jax.random.key(8), pop=64, iters=5, elites=8,
        mean0=sol.control_probs,
    )
    toggles = soft.binarize_controls(best_sample.astype(jnp.float32))
    final = soft.hard_rollout(problem.initial, toggles)
    assert int(hamming_cost(final, problem.target)) == 0


def test_sqp_solver_improves():
    problem = _toy_problem()
    key = jax.random.key(2)
    logits0 = solver.init_logits(key, problem, 4)
    start = jax.vmap(lambda l: solver.soft_objective(l, problem))(logits0)
    logits, _ = solver.solve_gradient(logits0, problem, iters=30)
    logits = solver.solve_sqp(logits, problem, iters=3, cg_iters=8)
    end = jax.vmap(lambda l: solver.soft_objective(l, problem))(logits)
    assert float(end.min()) < float(start.min())


@pytest.mark.gpu
def test_hard_score_batch_fused_matches_scan():
    problem = _toy_problem(horizon=4)
    key = jax.random.key(9)
    probs = jax.random.uniform(key, (8, 4, 64, 64))
    from lifeapi_tpu.mpc.solver import hard_score_batch

    costs_scan, finals_scan = hard_score_batch(probs, problem, use_fused=False)
    costs_fused, finals_fused = hard_score_batch(probs, problem, use_fused=True)
    assert (np.asarray(costs_scan) == np.asarray(costs_fused)).all()
    assert (np.asarray(finals_scan) == np.asarray(finals_fused)).all()


def test_hard_score_batch_engine_choice_on_cpu():
    """use_fused=None takes the platform's engine (XLA on the CPU) and
    equals use_fused=False; use_fused=True needs the CUDA kernel."""
    problem = _toy_problem(horizon=4)
    probs = jax.random.uniform(jax.random.key(9), (5, 4, 64, 64))
    from lifeapi_tpu.mpc.solver import hard_score_batch

    c0, f0 = hard_score_batch(probs, problem, use_fused=False)
    c1, f1 = hard_score_batch(probs, problem)
    assert (np.asarray(c0) == np.asarray(c1)).all()
    assert (np.asarray(f0) == np.asarray(f1)).all()
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        hard_score_batch(probs, problem, use_fused=True)


def test_stable_background_constraint():
    # a block in the protected region must survive the episode
    block = board.move(rle.parse("2o$2o!"), 10, 10)
    protected = board.to_dense(board.zoi(block))
    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 40, 40))
    mask = jnp.zeros((N, N), bool).at[36:46, 36:46].set(True)
    problem = MPCProblem(
        initial=block,
        target=target,
        horizon=4,
        control_mask=mask,
        protected=protected,
        background=block,
        weights=CostWeights(target=1.0, control=0.01, stable=5.0),
    )
    sol = solver.solve(problem, jax.random.key(3), n_candidates=8, iters=80)
    # block untouched, target reached
    assert bool(board.contains(sol.final_board, block))
    assert int(hamming_cost(sol.final_board, problem.target)) == 0


def test_receding_horizon_reaches_target():
    from lifeapi_tpu.mpc import receding

    problem = _toy_problem(horizon=4)
    # path cost makes the plan act inside the applied window instead of
    # deferring to the end of every lookahead
    problem = problem._replace(
        weights=CostWeights(target=1.0, control=0.01, path=1.0)
    )
    result = receding.run(
        problem, jax.random.key(11), steps=8, apply_horizon=2,
        n_candidates=8, solve_iters=80,
    )
    assert result.boards.shape[0] == 9
    err = receding.final_error(result, problem.target)
    assert int(err) == 0, int(err)


def test_receding_fused_one_dispatch():
    """run_fused: the whole receding loop in one jitted dispatch must (a)
    produce a trajectory that follows the exact dynamics step-for-step and
    (b) reach the target like the host-loop driver."""
    from lifeapi_tpu.mpc import receding

    problem = _toy_problem(horizon=4)
    problem = problem._replace(
        weights=CostWeights(target=1.0, control=0.01, path=1.0)
    )
    result = receding.run_fused(
        problem, jax.random.key(11), steps=8, apply_horizon=2,
        n_candidates=8, solve_iters=80,
    )
    assert result.boards.shape == (9, 64, 2)
    assert result.applied.shape == (8, 64, 2)
    assert result.costs.shape == (4,)
    # trajectory consistency: boards[i+1] == step(boards[i] ^ applied[i])
    for i in range(8):
        expect = step.step(result.boards[i] ^ result.applied[i])
        assert bool(board.equal(result.boards[i + 1], expect))
    err = receding.final_error(result, problem.target)
    assert int(err) == 0, int(err)
