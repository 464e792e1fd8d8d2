#!/usr/bin/env python
"""Multi-device weak-scaling benchmark for the sharded scenario sweep.

Measures the scaling efficiency of the elite-selection sweep over the
devices of the default backend (north-star target: >= 85%).  Run with
several GPUs for a device number; on a virtual CPU mesh (set up by the
caller, e.g. XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu) it only checks the collective plumbing.

Prints one JSON line per mesh size.
"""

import json
import time

import numpy as np
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run_sweep(n_devices, scenarios_per_device=2, candidates=4, iters=30):
    import jax
    import jax.numpy as jnp

    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.mpc import CostWeights
    from lifeapi_tpu.parallel import elite, make_mesh
    from lifeapi_tpu.target import LifeTarget

    devices = jax.devices()[:n_devices]
    mesh = make_mesh(n_scenario=n_devices, n_candidate=1, devices=devices)

    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 31, 31))
    mask = jnp.zeros((64, 64), bool).at[28:36, 28:36].set(True)
    S = scenarios_per_device * n_devices
    initials = jnp.broadcast_to(board.empty(), (S, 64, 2))

    def go():
        per_scenario, champion = elite.sharded_scenario_sweep(
            initials, target, 4, mask, mesh, jax.random.key(0),
            candidates_per_scenario=candidates, iters=iters,
            weights=CostWeights(),
        )
        np.asarray(per_scenario)  # readback fence
        return per_scenario

    go()  # compile
    t0 = time.perf_counter()
    go()
    dt = time.perf_counter() - t0
    return S * candidates / dt  # candidate-solves per second


def main():
    import jax

    n = len(jax.devices())
    sizes = sorted({1, 2, max(n // 2, 1), n})
    base = None
    for size in sizes:
        throughput = run_sweep(size)
        if size == 1:
            base = throughput
        eff = throughput / (base * size) if base else 1.0
        print(json.dumps({
            "metric": "sweep_scaling",
            "devices": size,
            "throughput_solves_per_sec": throughput,
            "weak_scaling_efficiency": eff,
        }))


if __name__ == "__main__":
    main()
