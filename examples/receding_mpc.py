#!/usr/bin/env python
"""Example: receding-horizon MPC — replan every 2 generations while
steering an empty torus into a block, verified bit-exactly."""

import jax
import jax.numpy as jnp

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.mpc import CostWeights, MPCProblem, receding
from lifeapi_tpu.target import LifeTarget, hamming_cost
from lifeapi_tpu.utils import compile_cache


def main():
    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 31, 31))
    problem = MPCProblem(
        initial=board.empty(),
        target=target,
        horizon=4,
        control_mask=jnp.zeros((64, 64), bool).at[24:40, 24:40].set(True),
        weights=CostWeights(target=1.0, control=0.01, path=1.0),
    )
    result = receding.run(problem, jax.random.key(0), steps=8,
                          apply_horizon=2, n_candidates=8, solve_iters=80)
    print("per-solve costs:", [round(c, 3) for c in result.costs.tolist()])
    print("final Hamming:", int(receding.final_error(result, target)))


if __name__ == "__main__":
    compile_cache.enable()
    main()
