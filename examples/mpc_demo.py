#!/usr/bin/env python
"""Example: MPC trajectory optimization — steer an empty torus into a
target still life with per-step cell toggles, then verify bit-exactly."""

import jax
import jax.numpy as jnp

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.mpc import CostWeights, MPCProblem, solver
from lifeapi_tpu.target import LifeTarget, hamming_cost
from lifeapi_tpu.utils import compile_cache


def main():
    target_state = board.move(rle.parse("2o$2o!"), 31, 31)
    problem = MPCProblem(
        initial=board.empty(),
        target=LifeTarget.from_state(target_state),
        horizon=8,
        control_mask=jnp.zeros((64, 64), bool).at[24:40, 24:40].set(True),
        weights=CostWeights(target=1.0, control=0.01),
    )
    sol = solver.solve(problem, jax.random.key(0), n_candidates=16, iters=150)
    print("hard cost:", float(sol.cost))
    print("Hamming to target:", int(hamming_cost(sol.final_board, problem.target)))
    print("toggles used:", int(board.population(sol.controls).sum()))


if __name__ == "__main__":
    compile_cache.enable()
    main()
