#!/usr/bin/env python
"""Minimal still-life completion of one hard instance, portfolio style.

The reference answers deep single-instance searches with a recursive DFS
(LifeStable.hpp:1340-1458); the batched answer is a PORTFOLIO: many
orbit-randomized beam replicas of the same instance in one batched
call, a seeded re-minimise pass, and (optionally) a champion-bounded
host-DFS polish that guarantees the exact minimum — the incumbent bound
prunes the reference recursion.

Run from the repo root:  python examples/portfolio_minimise.py
"""

import sys

import jax
import numpy as np

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.stable import complete
from lifeapi_tpu.utils import compile_cache


def main():
    # two anchor cells that must be ON, a dilated unknown area around them
    anchors = [(20, 20), (22, 22)]
    a = board.from_cells(anchors)
    area = board.zoi(board.zoi(a))
    state, unknown = a, area & ~a

    res = complete.complete_stable_portfolio(
        state, unknown, jax.random.key(0), replicas=128, frontier=4,
        iters=96, minimise=True, dfs_polish_timeout=10.0,
    )
    print(f"found={res.found} population={res.best_pop} "
          f"(replicas that completed: {res.found_fraction:.0%})")
    dense = complete._np_to_dense(res.best)
    print(rle.write_rle(dense))

    # independent stability check
    sys.path.insert(0, "tests")
    from oracle import life_step_dense

    assert (life_step_dense(dense) == dense).all(), "not a still life!"
    print("verified: still life containing both anchors:",
          bool(dense[20, 20] and dense[22, 22]))


if __name__ == "__main__":
    compile_cache.enable()
    main()
