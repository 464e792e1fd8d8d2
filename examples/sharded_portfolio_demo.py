#!/usr/bin/env python
"""One HARD still-life instance scaled over a device mesh.

`parallel.elite.sharded_portfolio` shards orbit-randomized beam replicas
of a single completion problem over every device, exchanges the champion
with pmin/psum collectives, and feeds its population back as a
branch-and-bound incumbent for a second bounded pass on all devices
(SURVEY.md §2.8 "sharded search / elite selection" composed with the
reference's deep-DFS workload, LifeStable.hpp:1340-1458).

Runs on every device of the default backend (one card or several).  On
the CPU it asks for 8 virtual devices, which exercises the real
shard_map/collective code paths.

Run from the repo root:  python examples/sharded_portfolio_demo.py
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# 8 virtual devices if this runs on the CPU backend (must be set before
# jax initializes; the collective code is identical)
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lifeapi_tpu.core import board, rle  # noqa: E402
from lifeapi_tpu.core.step import step as life_step  # noqa: E402
from lifeapi_tpu.parallel import elite, make_mesh  # noqa: E402
from lifeapi_tpu.utils import compile_cache  # noqa: E402


def main():
    # an eater with two cells knocked out and a ring of unknowns: the
    # search must rediscover a stable background
    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)])
    state = eater & ~hide
    unknown = (board.zoi(eater) & ~eater) | hide

    mesh = make_mesh()  # every device on the scenario axis
    n = mesh.devices.size
    print(f"mesh: {n} devices ({jax.devices()[0].platform})")

    res = elite.sharded_portfolio(
        state, unknown, jax.random.key(0), mesh,
        replicas=8 * n, frontier=4, iters=48, two_phase=True,
    )
    assert res.found, "portfolio found no completion"
    champ = jnp.asarray(res.best)
    assert bool(board.equal(life_step(champ), champ)), "not a still life?!"
    print(f"champion population: {res.best_pop} "
          f"(replica success rate {res.found_fraction:.0%})")
    print(rle.to_rle(champ))


if __name__ == "__main__":
    compile_cache.enable()
    main()
