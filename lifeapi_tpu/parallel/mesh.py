"""Device-mesh construction helpers.

The framework's scaling dimensions (SURVEY.md section 2.8): ``scenario``
(independent MPC problems / search seeds — the data-parallel axis, sharded
across hosts over DCN) and ``candidate`` (control candidates / branch
portfolios per scenario — sharded across chips over ICI).  Collectives are
XLA-compiled (psum / all_gather); there is no external comm library.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401

SCENARIO_AXIS = "scenario"
CANDIDATE_AXIS = "candidate"


def make_mesh(n_scenario=None, n_candidate=None, devices=None):
    """2D mesh over available devices: (scenario, candidate).

    Defaults put all devices on the scenario axis.  On a multi-host pod the
    scenario axis should span hosts (DCN) and the candidate axis stay
    within a slice (ICI)."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_scenario is None and n_candidate is None:
        n_scenario, n_candidate = n, 1
    elif n_scenario is None:
        n_scenario = n // n_candidate
    elif n_candidate is None:
        n_candidate = n // n_scenario
    assert n_scenario * n_candidate == n, (n_scenario, n_candidate, n)
    arr = np.asarray(devices).reshape(n_scenario, n_candidate)
    return Mesh(arr, (SCENARIO_AXIS, CANDIDATE_AXIS))


def initialize_distributed(coordinator=None, num_processes=None, process_id=None):
    """Multi-host bring-up (reference has no distributed layer; this is the
    runtime entry, jax.distributed across hosts)."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
