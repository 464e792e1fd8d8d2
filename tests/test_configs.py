"""End-to-end tests mirroring the five north-star benchmark configs
(BASELINE.json)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lifeapi_tpu.core import board, rle, step
from lifeapi_tpu.mpc import CostWeights, MPCProblem, solver
from lifeapi_tpu.target import LifeTarget, hamming_cost

N = 64


def test_config1_glider_to_target_horizon32_bitexact():
    """Single torus, glider -> fixed LifeTarget, horizon 32, bit-exact
    check vs the independent native oracle."""
    from lifeapi_tpu.native import build as nb

    glider = board.move(rle.parse("bob$2bo$3o!"), 10, 10)
    rolled = step.step_n(glider, 32)

    # oracle agreement at every generation
    cur64 = nb.packed32_to_packed64(np.asarray(glider))
    for _ in range(32):
        cur64 = nb.step_packed64(cur64)
    assert (nb.packed64_to_packed32(cur64) == np.asarray(rolled)).all()

    # a glider translates by (8, 8) after 32 generations
    target = LifeTarget.from_state(board.move(glider, 8, 8))
    assert int(hamming_cost(rolled, target)) == 0


def test_config2_batched_rollouts_hamming():
    """Batched boards/chip: random-soup rollouts + Hamming cost to a
    target, horizon 64 (scaled-down batch for the CPU test mesh)."""
    key = jax.random.key(0)
    boards = board.random(key, (128,), p=0.35)
    out = step.step_n(boards, 64)
    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 31, 31))
    costs = hamming_cost(out, target)
    assert costs.shape == (128,)
    assert (np.asarray(costs) >= 0).all()
    # the public rollout (the platform's engine) agrees with the scan path
    got = step.rollout(boards, 64)
    assert bool(board.equal(got, out).all())


def test_config3_soft_mpc_with_stable_background():
    """Soft-Life relaxed MPC with a still-life background constraint —
    covered in depth by test_mpc.py::test_stable_background_constraint;
    here: the solver must also *verify* the background with the stable
    machinery."""
    from lifeapi_tpu.mpc import symmetric as sym_mod

    blk = board.move(rle.parse("2o$2o!"), 10, 10)
    region = jnp.zeros((N, N), bool).at[8:14, 8:14].set(True)
    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 40, 40))
    mask = jnp.zeros((N, N), bool).at[36:46, 36:46].set(True)
    problem = MPCProblem(
        initial=blk, target=target, horizon=4, control_mask=mask,
        protected=board.to_dense(board.zoi(blk)), background=blk,
        weights=CostWeights(target=1.0, control=0.01, stable=5.0),
    )
    sol = solver.solve(problem, jax.random.key(1), n_candidates=8, iters=80)
    assert int(hamming_cost(sol.final_board, target)) == 0
    assert bool(sym_mod.stable_consistency(sol.final_board, region))


def test_config4_symmetry_constrained():
    """C2 orbit constraint + stable propagation in-loop — exercised by
    test_symmetric_mpc.py; this checks a D4even variant end to end."""
    from lifeapi_tpu.mpc import symmetric as sym_mod
    from lifeapi_tpu.symmetry import StaticSymmetry as S
    from lifeapi_tpu.symmetry.groups import GROUPS
    from lifeapi_tpu.symmetry import transforms as tr

    blk = board.move(rle.parse("2o$2o!"), 20, 20)
    target_state = blk
    for t in GROUPS[S.D4even]:
        target_state = target_state | tr.transform(blk, t)
    target = LifeTarget.from_state(target_state)
    mask = sym_mod.orbit_symmetrize(
        jnp.zeros((N, N)).at[18:24, 18:24].set(1.0), S.D4even
    ) > 0
    problem = MPCProblem(
        initial=board.empty(), target=target, horizon=2, control_mask=mask,
        weights=CostWeights(target=1.0, control=0.005),
    )
    sol = sym_mod.solve_symmetric(
        problem, jax.random.key(2), S.D4even, n_candidates=8, iters=150
    )
    assert int(hamming_cost(sol.final_board, target)) == 0


def test_config5_multihost_sweep():
    """Scenario sweep across the virtual 8-device mesh with elite
    all_gather — the multi-host pattern (scaled down)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from lifeapi_tpu.parallel import elite, make_mesh

    mesh = make_mesh(n_scenario=4, n_candidate=2)
    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 31, 31))
    mask = jnp.zeros((N, N), bool).at[28:36, 28:36].set(True)
    initials = jnp.broadcast_to(board.empty(), (8, N, 2))
    per_scenario, champion = elite.sharded_scenario_sweep(
        initials, target, 3, mask, mesh, jax.random.key(3),
        candidates_per_scenario=4, iters=150,
        weights=CostWeights(target=1.0, control=0.01),
    )
    assert float(champion) == float(np.asarray(per_scenario).min())
    # at least one scenario reaches the target exactly (cost < 1 means
    # hamming 0 + small control effort)
    assert float(champion) < 1.0
