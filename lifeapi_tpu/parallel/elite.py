"""Sharded scenario sweeps with cross-device elite selection.

The multi-host search pattern of the north star: scenarios and candidate
controls are sharded over the mesh, every device optimizes its local
candidates, hard-scores them bit-exactly, takes a local top-k, and the
elite set is exchanged with one small ``all_gather`` (costs ride a
``psum``-friendly layout).  No parameter server: XLA collectives under
``shard_map`` only (SURVEY.md section 5.8)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..mpc import solver as solver_mod
from .mesh import CANDIDATE_AXIS, SCENARIO_AXIS


def local_topk(costs, k):
    """(values, indices) of the k lowest costs."""
    neg_vals, idx = jax.lax.top_k(-costs, k)
    return -neg_vals, idx


def sharded_candidate_solve(problem, logits0, mesh, iters=60, topk=4,
                            lr=0.15):
    """Optimize candidates sharded over BOTH mesh axes for a single
    problem; return the globally best controls and costs.

    logits0: [C, T, 64, 64] with C divisible by the mesh size.  Flow per
    device: gradient-optimize local shard -> binarize + hard-score ->
    local top-k -> all_gather elites over both axes -> global argmin.

    Note: the runner closes over ``problem`` (arrays), so each CALL
    compiles fresh — fine for one sweep per problem set, which is this
    function's use.  Repeat-call workloads should follow the cached-
    runner pattern of _sharded_beam_runner.
    """

    both = (SCENARIO_AXIS, CANDIDATE_AXIS)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(both),),
        out_specs=(P(), P(both)),
        check_vma=False,
    )
    def run(logits_local):
        logits, _ = solver_mod.solve_gradient(
            logits_local, problem, iters=iters, lr=lr
        )
        probs = jax.nn.sigmoid(logits) * problem.control_mask
        costs, _ = jax.vmap(lambda p: solver_mod.hard_score(p, problem))(probs)

        k = min(topk, costs.shape[0])
        vals, idx = local_topk(costs, k)
        elite_probs = probs[idx]

        all_vals = jax.lax.all_gather(vals, both, tiled=True)
        all_probs = jax.lax.all_gather(elite_probs, both, tiled=True)
        best = jnp.argmin(all_vals)
        best_probs = all_probs[best]
        best_cost = all_vals[best]
        return (best_cost, best_probs), costs

    (best_cost, best_probs), all_costs = run(logits0)
    return best_cost, best_probs, all_costs


def sharded_scenario_sweep(problems_initial, target, horizon, control_mask,
                           mesh, key, candidates_per_scenario=8, iters=40,
                           weights=None):
    """Many scenarios (initial boards) sharded over the scenario axis, each
    with a candidate population sharded over the candidate axis.  Returns
    per-scenario best hard costs and the global champion scenario.

    problems_initial: packed uint32[S, 64, 2]; S divisible by the scenario
    axis size."""
    from ..mpc import cost as cost_mod

    weights = weights or cost_mod.CostWeights()
    T = horizon
    S = problems_initial.shape[0]
    C = candidates_per_scenario

    logits0 = solver_mod.init_logits(
        key, solver_mod.MPCProblem(problems_initial[0], target, T, control_mask,
                                   weights=weights),
        S * C,
    ).reshape(S, C, T, 64, 64)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS, CANDIDATE_AXIS)),
        out_specs=(P(SCENARIO_AXIS), P()),
        check_vma=False,
    )
    def run(initial_local, logits_local):
        def solve_one(initial, logits):
            problem = solver_mod.MPCProblem(
                initial, target, T, control_mask, weights=weights
            )
            lg, _ = solver_mod.solve_gradient(logits, problem, iters=iters)
            probs = jax.nn.sigmoid(lg) * control_mask
            costs, _ = jax.vmap(
                lambda p: solver_mod.hard_score(p, problem)
            )(probs)
            local_best = jnp.min(costs)
            # combine candidate shards within a scenario
            return jax.lax.pmin(local_best, CANDIDATE_AXIS)

        per_scenario = jax.vmap(solve_one)(initial_local, logits_local)
        # global champion across the scenario axis
        all_best = jax.lax.all_gather(
            jnp.min(per_scenario), SCENARIO_AXIS, tiled=False
        )
        return per_scenario, jnp.min(all_best)

    return run(problems_initial, logits0)


def sharded_beam_complete(bst, mesh, frontier=4, iters=32, minimise=True,
                          two_phase=False):
    """Stable-completion beam search data-parallel over the WHOLE mesh,
    with a cross-device champion exchange — the sharded counterpart of
    stable/complete.complete_stable_beam (SURVEY.md section 2.8: sharded
    search / elite selection).

    ``bst``: packed BitStable with [B, ...] leading axis, B divisible by
    the mesh size.  Each device runs the jnp beam on its shard, then the
    globally minimal-population completion is selected by a pmin over a
    device-unique key and broadcast by psum (the single winning device
    contributes the board).  Returns (found[B], best[B, 64, 2],
    best_pop[B], champion board [64, 2], champion pop []).

    ``two_phase``: after the exchange, every device re-searches its shard
    BOUNDED by the global champion's population (init_bound) — the elite
    exchange feeding back into the search as a branch-and-bound incumbent
    (collectives pruning compute, not just reporting it).  Only the
    CHAMPION outputs are refined: per-problem found/best/pop keep phase-1
    semantics (a cross-problem bound would wrongly suppress per-problem
    completions above the global champion).
    """
    run = _sharded_beam_runner(mesh, frontier, iters, minimise, two_phase)
    bst_in = type(bst)(bst.state, bst.unknown, tuple(bst.ruled))
    return run(bst_in)


@functools.lru_cache(maxsize=32)
def _sharded_beam_runner(mesh, frontier, iters, minimise, two_phase):
    """Cached shard_map'd runner for sharded_beam_complete: Mesh is
    value-hashable, so repeat calls with the same configuration reuse
    ONE compiled executable instead of re-tracing and re-compiling."""
    from ..stable import complete as C

    both = (SCENARIO_AXIS, CANDIDATE_AXIS)
    n_dev = mesh.devices.size

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(both),),
        out_specs=(P(both), P(both), P(both), P(), P()),
        check_vma=False,
    )
    def run(bst_local):
        SENTINEL = jnp.int32(5000)  # > max population 4096
        rank = (jax.lax.axis_index(SCENARIO_AXIS)
                * jax.lax.axis_size(CANDIDATE_AXIS)
                + jax.lax.axis_index(CANDIDATE_AXIS))

        def exchange(found_x, best_x, pop_x):
            key = jnp.where(found_x, jnp.minimum(pop_x, SENTINEL), SENTINEL)
            li = jnp.argmin(key)
            # device-unique combined key makes the winner unique, so the
            # psum below has exactly one nonzero contributor (pop <= 4096
            # keeps this well inside int32)
            combined = key[li] * n_dev + rank
            gmin = jax.lax.pmin(combined, both)
            champ_local = jnp.where(combined == gmin, best_x[li],
                                    jnp.zeros_like(best_x[li]))
            champ = jax.lax.psum(champ_local, both)
            return champ, gmin // n_dev

        found, best, pop, proved = C.beam_search_jnp(
            bst_local, frontier, iters, minimise)
        champ, champ_pop = exchange(found, best, pop)

        if two_phase:
            f2, b2, p2, _ = C.beam_search_jnp(
                bst_local, frontier, iters, minimise, init_bound=champ_pop)
            champ2, champ2_pop = exchange(f2, b2, p2)
            improved = champ2_pop < champ_pop
            champ = jnp.where(improved, champ2, champ)
            champ_pop = jnp.where(improved, champ2_pop, champ_pop)

        return found, best, pop, champ, champ_pop

    return run


def sharded_portfolio(state, unknown, key, mesh, replicas=256, frontier=4,
                      iters=192, minimise=True, two_phase=True,
                      dfs_polish_timeout=None):
    """Single-hard-instance portfolio search sharded over the WHOLE mesh —
    the missing SURVEY §2.8 composition for the reference's deep-DFS
    workload (LifeStable.hpp:1340-1458): ONE stable-completion instance,
    ``replicas`` orbit-randomized beam replicas (symmetry transform
    ``r % 16`` + random torus translation each), replicas data-parallel
    over the mesh with a pmin/psum champion exchange.

    With ``two_phase`` the exchanged champion's population feeds back as
    a branch-and-bound incumbent (``init_bound``) for a second bounded
    pass on every device — the collectives prune compute, not just
    report it.  ``dfs_polish_timeout`` optionally runs the
    champion-bounded host DFS on the lead process afterwards (the
    reference's exhaustive-minimality semantics; host rank 0 only —
    jax.process_index() == 0).

    Per-replica results are bit-exact regardless of the mesh shape (pure
    data parallelism), and the champion's population is mesh-invariant
    (its identity may tie-break by device rank); tests/test_portfolio.py
    pins both on 1/2/8-device CPU meshes.

    ``state``/``unknown``: packed uint32[64, 2].  Returns
    stable.complete.PortfolioResult (champion back-transformed to the
    original orientation).
    """
    import numpy as np

    from ..core import board as BRD
    from ..stable import bitplane as BP
    from ..stable import complete as C
    from ..symmetry import transforms as TR

    n_dev = mesh.devices.size
    if replicas % n_dev:
        raise ValueError(f"replicas={replicas} not divisible by mesh size "
                         f"{n_dev}")
    local_R = replicas // n_dev

    kx, ky = jax.random.split(key)
    dx = jax.random.randint(kx, (replicas,), 0, 64)
    dy = jax.random.randint(ky, (replicas,), 0, 64)
    st_r, un_r = jax.jit(C._build_replicas)(state, unknown, dx, dy)
    bst = BP.make(state=st_r, unknown=un_r)

    run = _sharded_portfolio_runner(mesh, replicas, frontier, iters,
                                    minimise, two_phase)
    found, champ, champ_pop, champ_idx = run(bst)
    found_np = np.asarray(found)
    if int(champ_pop) >= 5000:  # SENTINEL: nothing found anywhere
        return C.PortfolioResult(False, np.zeros((64, 2), np.uint32), 0, 0.0)

    i = int(champ_idx)
    t = int(i % 16)
    back = BRD.move(jnp.asarray(champ), -int(dx[i]), -int(dy[i]))
    back = TR.transform(back, TR.transform_inverse(t))
    best_pop = int(champ_pop)
    champ_np = np.asarray(back)

    if minimise and dfs_polish_timeout and jax.process_index() == 0:
        # champion-bounded host DFS polish (reference exhaustive
        # semantics, LifeStable.hpp:1353-1356); lead process only — its
        # result does not enter any collective, so multi-host processes
        # stay consistent on the device-side champion
        import time as _time

        hst = C.HostStable(
            state=C._np_to_dense(np.asarray(state)),
            unknown=C._np_to_dense(np.asarray(unknown)),
        )
        search = C._Search(_time.monotonic() + float(dfs_polish_timeout),
                           True, False, np.zeros((64, 64), bool))
        search.max_pop = best_pop
        search.step(hst)
        if search.best is not None and search.best.any():
            pop_h = int(search.best.sum())
            if pop_h < best_pop:
                best_pop = pop_h
                champ_np = np.asarray(C._np_from_dense(search.best))

    return C.PortfolioResult(
        True, champ_np, best_pop, float(found_np.mean()))


@functools.lru_cache(maxsize=32)
def _sharded_portfolio_runner(mesh, replicas, frontier, iters, minimise,
                              two_phase):
    """Cached shard_map'd runner for sharded_portfolio (same rationale as
    _sharded_beam_runner: a fresh closure per call means a fresh compile
    per call)."""
    from ..stable import complete as C

    both = (SCENARIO_AXIS, CANDIDATE_AXIS)
    n_dev = mesh.devices.size
    local_R = replicas // n_dev

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(both),),
        out_specs=(P(both), P(), P(), P()),
        check_vma=False,
    )
    def run(bst_local):
        SENTINEL = jnp.int32(5000)  # > max population 4096
        rank = (jax.lax.axis_index(SCENARIO_AXIS)
                * jax.lax.axis_size(CANDIDATE_AXIS)
                + jax.lax.axis_index(CANDIDATE_AXIS))

        def exchange(found_x, best_x, pop_x):
            key_ = jnp.where(found_x, jnp.minimum(pop_x, SENTINEL), SENTINEL)
            li = jnp.argmin(key_)
            # device-unique combined key -> unique winner -> the psums
            # below have exactly one nonzero contributor
            combined = key_[li] * n_dev + rank
            gmin = jax.lax.pmin(combined, both)
            win = combined == gmin
            champ = jax.lax.psum(
                jnp.where(win, best_x[li], jnp.zeros_like(best_x[li])), both)
            gidx = jax.lax.psum(
                jnp.where(win, rank * local_R + li, 0), both)
            return champ, gmin // n_dev, gidx

        found, best, pop, _ = C.beam_search_jnp(
            bst_local, frontier, iters, minimise)
        champ, champ_pop, champ_idx = exchange(found, best, pop)

        if two_phase and minimise:
            f2, b2, p2, _ = C.beam_search_jnp(
                bst_local, frontier, iters, minimise, init_bound=champ_pop)
            champ2, champ2_pop, champ2_idx = exchange(f2, b2, p2)
            improved = champ2_pop < champ_pop
            champ = jnp.where(improved, champ2, champ)
            champ_idx = jnp.where(improved, champ2_idx, champ_idx)
            champ_pop = jnp.minimum(champ_pop, champ2_pop)

        return found, champ, champ_pop, champ_idx

    return run


def sharded_rollout(boards, steps, mesh):
    """Bit-exact Life rollout data-parallel over the whole mesh with a
    psum population reduction: boards [B, 64, 2] sharded over both axes,
    each shard stepped ``steps`` generations by core.step.rollout (the
    platform's engine).  Returns (final boards [B, 64, 2], global total
    population [])."""
    return _sharded_rollout_runner(mesh, steps)(boards)


@functools.lru_cache(maxsize=32)
def _sharded_rollout_runner(mesh, steps):
    from ..core import board as BRD
    from ..core import step as S

    both = (SCENARIO_AXIS, CANDIDATE_AXIS)

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(both),),
        out_specs=(P(both), P()),
        check_vma=False,
    )
    def run(local):
        final = S.rollout(local, steps)
        local_pop = jnp.sum(BRD.population(final))
        return final, jax.lax.psum(local_pop, both)

    return run


def sharded_catalyst_search(active, catalyst, offsets, horizon, mesh,
                            engine=None):
    """Catalyst placement sweep data-parallel over the whole mesh:
    ``offsets`` int32[P, 2] sharded across devices (P a multiple of the
    device count), each shard running the full search.py pipeline
    locally, plus a psum of the global hit count.  Returns
    (interacted bool[P], recovered bool[P], global_hits []).

    ``engine`` is search.catalyst_search's per-shard engine (None: the
    platform's choice, lifeapi_tpu.platform); both engines are bit-exact
    (tests/test_search.py)."""
    return _sharded_catalyst_runner(mesh, horizon, engine)(
        active, catalyst, offsets)


@functools.lru_cache(maxsize=32)
def _sharded_catalyst_runner(mesh, horizon, engine):
    from .. import search as SR

    both = (SCENARIO_AXIS, CANDIDATE_AXIS)

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(both)),
        out_specs=(P(both), P(both), P()),
        check_vma=False,
    )
    def run(active_l, catalyst_l, offsets_l):
        res = SR.catalyst_search(active_l, catalyst_l, offsets_l, horizon,
                                 engine=engine)
        hits = SR.successful_catalysts(res)
        return (res.interacted, res.recovered,
                jax.lax.psum(jnp.sum(hits, dtype=jnp.int32), both))

    return run
