"""Single-hard-instance portfolio search (complete.complete_stable_portfolio):
orbit-randomized beam replicas of ONE problem in one batched kernel call."""

import numpy as np
import jax
import jax.numpy as jnp

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.core.step import step as life_step
from lifeapi_tpu.stable import complete as C


def test_portfolio_reconstructs_eater():
    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20), (22, 20)])
    unknown = (board.zoi(eater) & ~eater) | hide
    state = eater & ~hide
    res = C.complete_stable_portfolio(
        state, unknown, jax.random.key(0), replicas=32, frontier=4,
        iters=24,
    )
    assert res.found
    b = jnp.asarray(res.best)
    # a genuine still life, consistent with the knowns, inside the area,
    # in the ORIGINAL orientation (back-transform correctness)
    assert bool(board.equal(life_step(b), b))
    assert bool(board.is_empty(state & ~b))
    assert bool(board.is_empty(b & ~(state | unknown)))
    # minimal known completion of this instance is the eater itself
    assert res.best_pop <= int(board.population(eater))


def test_portfolio_reminimise_matches_dfs():
    """Round-2 VERDICT weak #5: with the seeded BigZOI re-minimise pass,
    the portfolio's population must come within +1 of the exhaustive host
    DFS on every instance of a small sweep (the >=20-instance measured
    sweep lives in benches/portfolio_sweep.py)."""
    import numpy as np

    from lifeapi_tpu.stable import host as H

    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    cells = [(20, 20), (21, 20), (22, 20), (21, 21), (23, 22), (23, 23)]
    for k in range(3):
        hide = board.from_cells(cells[k:k + 3])
        unknown = (board.zoi(eater) & ~eater) | hide
        state = eater & ~hide

        st_dense = np.asarray(board.to_dense(state))
        un_dense = np.asarray(board.to_dense(unknown))
        host_st = H.HostStable(
            st_dense.copy(), un_dense.copy(),
            np.zeros((64, 64), np.uint8),
        )
        r, best = C.complete_stable(host_st, timeout=30.0, minimise=True)
        assert r == C.CompletionResult.COMPLETED
        dfs_pop = int(best.sum())

        res = C.complete_stable_portfolio(
            state, unknown, jax.random.key(100 + k), replicas=32,
            frontier=4, iters=48, reminimise=True,
        )
        assert res.found
        b = jnp.asarray(res.best)
        assert bool(board.equal(life_step(b), b))
        assert bool(board.is_empty(state & ~b))
        assert res.best_pop <= dfs_pop + 1, (k, res.best_pop, dfs_pop)


def test_portfolio_unsat_instance():
    lone = board.from_cells([(40, 40)])
    none = jnp.zeros((64, 2), jnp.uint32)
    res = C.complete_stable_portfolio(
        lone, none, jax.random.key(1), replicas=16, frontier=4, iters=8,
    )
    assert not res.found
    assert res.found_fraction == 0.0


def test_sharded_portfolio_mesh_invariance():
    """VERDICT r04 directive #3: replicas sharded over the mesh with a
    pmin/psum champion exchange.  Per-replica search is pure data
    parallelism, so the champion's population (and validity) must be
    IDENTICAL on 1-, 2- and 8-device meshes over the same replica set."""
    from lifeapi_tpu.parallel import elite, make_mesh

    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)])
    unknown = (board.zoi(eater) & ~eater) | hide
    state = eater & ~hide

    results = []
    for n_dev in (1, 2, 8):
        mesh = make_mesh(n_scenario=n_dev, n_candidate=1,
                         devices=jax.devices()[:n_dev])
        res = elite.sharded_portfolio(
            state, unknown, jax.random.key(7), mesh, replicas=16,
            frontier=2, iters=16, two_phase=(n_dev == 8),
        )
        results.append(res)
        assert res.found
        b = jnp.asarray(res.best)
        # champion validity: genuine still life consistent with knowns,
        # back-transformed to the original orientation
        assert bool(board.equal(life_step(b), b))
        assert bool(board.is_empty(state & ~b))
        assert bool(board.is_empty(b & ~(state | unknown)))
    pops = [r.best_pop for r in results]
    assert pops[0] == pops[1] == pops[2], pops
    fracs = [r.found_fraction for r in results]
    assert fracs[0] == fracs[1] == fracs[2], fracs


def test_sharded_portfolio_unsat_and_polish():
    from lifeapi_tpu.parallel import elite, make_mesh

    mesh = make_mesh(n_scenario=2, n_candidate=1,
                     devices=jax.devices()[:2])
    # unsatisfiable: a lone cell with no unknowns cannot be stabilized
    lone = board.from_cells([(40, 40)])
    none = jnp.zeros((64, 2), jnp.uint32)
    res = elite.sharded_portfolio(
        lone, none, jax.random.key(1), mesh, replicas=4, frontier=2,
        iters=4)
    assert not res.found

    # DFS polish path: the bounded host DFS can only improve the champion
    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)])
    unknown = (board.zoi(eater) & ~eater) | hide
    state = eater & ~hide
    res0 = elite.sharded_portfolio(
        state, unknown, jax.random.key(7), mesh, replicas=8, frontier=2,
        iters=16, two_phase=False)
    res1 = elite.sharded_portfolio(
        state, unknown, jax.random.key(7), mesh, replicas=8, frontier=2,
        iters=16, two_phase=False, dfs_polish_timeout=5.0)
    assert res1.found and res1.best_pop <= res0.best_pop
    b = jnp.asarray(res1.best)
    assert bool(board.equal(life_step(b), b))
    assert bool(board.is_empty(state & ~b))
