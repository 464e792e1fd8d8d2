"""The batched beam completer (stable.complete.complete_stable_beam and
its queued form) against independent references: the exact Life step
of tests/oracle.py and the host DFS (reference CompleteStableStep
semantics, LifeStable.hpp:1340-1412)."""

import time

import numpy as np
import jax.numpy as jnp

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.stable import bitplane as BP
from lifeapi_tpu.stable import complete as C
from lifeapi_tpu.stable import host as H
from lifeapi_tpu.stable import propagate as P
from oracle import life_step_dense

N = 64
EATER = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)


def _eater_problem(hide_cells, ring=1):
    hide = board.from_cells(hide_cells)
    zone = board.zoi(EATER) if ring == 1 else board.zoi(board.zoi(EATER))
    return EATER & ~hide, (zone & ~EATER) | hide


def _dfs(state, unknown, minimise):
    """(verdict, best dense board or None) of the raw host DFS recursion.
    With ``minimise`` the exhausted search returns INCONSISTENT once no
    smaller completion is left; ``best`` is then the minimum, or None if
    the instance has no completion at all."""
    search = C._Search(time.monotonic() + 30.0, minimise, False,
                       np.zeros((N, N), bool))
    verdict = search.step(H.HostStable(state=state, unknown=unknown))
    return verdict, search.best


def _assert_valid(best, state, unknown):
    """``best`` (dense) is a still life holding every known-ON cell and
    nothing outside state | unknown."""
    assert (life_step_dense(best) == best).all()
    assert (best & state == state).all()
    assert not (best & ~(state | unknown)).any()


def _random_instances(rng, n, pieces=3):
    states, unknowns = [], []
    for _ in range(n):
        truth = np.zeros((N, N), bool)
        for _ in range(pieces):
            x, y = rng.integers(8, 52, 2)
            truth[x:x + 2, y:y + 2] = True
        hide = (rng.random((N, N)) < 0.35) & H.zoi(truth)
        states.append(truth & ~hide)
        unknowns.append(hide | (H.zoi(truth) & ~truth))
    return np.stack(states), np.stack(unknowns)


def test_beam_padding_path():
    """An odd batch (33 problems, distinct translations) gives each
    problem the result it gets alone in a smaller batch: problems never
    interact, whatever the batch size."""
    state, unknown = _eater_problem([(20, 20), (21, 20)])
    B = 33
    sts = jnp.stack([jnp.roll(state, 3 * i, axis=-2) for i in range(B)])
    uns = jnp.stack([jnp.roll(unknown, 3 * i, axis=-2) for i in range(B)])
    full = C.complete_stable_beam(BP.make(state=sts, unknown=uns),
                                  frontier=4, iters=6, dense=False)
    part = C.complete_stable_beam(BP.make(state=sts[5:12], unknown=uns[5:12]),
                                  frontier=4, iters=6, dense=False)
    assert (full.found[5:12] == part.found).all()
    assert (full.best_pop[5:12] == part.best_pop).all()
    assert (full.best[5:12] == part.best).all()
    assert (full.proved_inconsistent[5:12] == part.proved_inconsistent).all()


def test_beam_minimise_false_inconsistent():
    """minimise=False (the weld.unweldable_mask mode) on a batch mixing
    satisfiable instances with an unsatisfiable one: the satisfiable ones
    are completed to genuine still lifes, the unsatisfiable one is proved
    inconsistent, and the host DFS agrees on both verdicts."""
    state, unknown = _eater_problem([(20, 20), (21, 20)])
    sat_state = np.asarray(board.to_dense(state))
    sat_unknown = np.asarray(board.to_dense(unknown))
    # unsatisfiable: a lone ON cell whose whole neighbourhood is known OFF
    lone = np.asarray(board.to_dense(board.from_cells([(40, 40)])))
    none = np.zeros((N, N), bool)
    states = np.stack([sat_state, lone, sat_state])
    unknowns = np.stack([sat_unknown, none, sat_unknown])
    res = C.complete_stable_beam(
        P.make(state=jnp.asarray(states), unknown=jnp.asarray(unknowns)),
        frontier=8, iters=16, minimise=False)
    assert res.found[0] and res.found[2] and not res.found[1]
    assert res.proved_inconsistent[1] and not res.proved_inconsistent[0]
    for i in (0, 2):
        _assert_valid(res.best[i], states[i], unknowns[i])
    assert _dfs(lone, none, False)[0] == C.CompletionResult.INCONSISTENT
    assert _dfs(sat_state, sat_unknown, False)[0] == (
        C.CompletionResult.COMPLETED)


def test_beam_seeded_completion():
    """Seed-proximity branching (reference useSeed, LifeStable.hpp:
    1366-1375) still returns genuine still lifes consistent with the
    knowns, no smaller than the DFS minimum."""
    state, unknown = _eater_problem([(20, 20), (21, 20), (22, 21)], ring=2)
    B = 3
    st = P.make(
        state=jnp.broadcast_to(board.to_dense(state), (B, N, N)),
        unknown=jnp.broadcast_to(board.to_dense(unknown), (B, N, N)),
    )
    seed = jnp.broadcast_to(state, (B, 64, 2))
    res = C.complete_stable_beam(st, frontier=4, iters=24, minimise=True,
                                 seed=seed)
    s_d = np.asarray(board.to_dense(state))
    u_d = np.asarray(board.to_dense(unknown))
    _, dfs_best = _dfs(s_d, u_d, True)
    assert res.found.all()
    for i in range(B):
        _assert_valid(res.best[i], s_d, u_d)
        assert res.best_pop[i] == res.best[i].sum() >= dfs_best.sum()


def test_beam_random_instances_vs_dfs(rng):
    """Random block-field reconstructions, minimise=True, F=8: every
    completion is valid and no smaller than the DFS minimum, and every
    inconsistency proof is confirmed by the DFS."""
    states, unknowns = _random_instances(rng, 6)
    res = C.complete_stable_beam(
        P.make(state=jnp.asarray(states), unknown=jnp.asarray(unknowns)),
        frontier=8, iters=12, minimise=True)
    for i in range(len(states)):
        _, best = _dfs(states[i], unknowns[i], True)
        if res.found[i]:
            _assert_valid(res.best[i], states[i], unknowns[i])
            assert best is not None
            assert res.best_pop[i] >= best.sum()
        if res.proved_inconsistent[i]:
            assert best is None
    assert res.found.any()


def test_beam_init_bound():
    """init_bound = branch-and-bound with a known incumbent: candidates
    at/above the bound prune; found means strictly better."""
    state, unknown = _eater_problem([(20, 20), (21, 20)])
    bst = BP.make(
        state=jnp.broadcast_to(state, (4, 64, 2)),
        unknown=jnp.broadcast_to(unknown, (4, 64, 2)),
    )
    # bound 7 (the minimum) -> nothing strictly better
    r_tight = C.complete_stable_beam(bst, frontier=4, iters=24,
                                     minimise=True, dense=False,
                                     init_bound=7)
    assert not r_tight.found.any()
    # bound 8: the pop-7 eater must be found
    r_loose = C.complete_stable_beam(bst, frontier=4, iters=24,
                                     minimise=True, dense=False,
                                     init_bound=8)
    assert r_loose.found.all()
    assert (np.asarray(r_loose.best_pop) == 7).all()


def test_complete_stable_beam_queued_matches_per_chunk():
    """The queued multi-batch API must equal per-chunk beam calls
    exactly, including the non-multiple padding path."""
    state, unknown = _eater_problem([(20, 20), (21, 20)])
    B = 21  # deliberately not a chunk multiple
    sts = jnp.stack([jnp.roll(state, i, axis=-2) for i in range(B)])
    uns = jnp.stack([jnp.roll(unknown, i, axis=-2) for i in range(B)])
    bst = BP.make(state=sts, unknown=uns)

    got = C.complete_stable_beam_queued(bst, chunk=8, frontier=4, iters=16)
    assert got.best is None and got.found.shape == (B,)
    for lo in range(0, B, 8):
        part = BP.make(state=sts[lo:lo + 8], unknown=uns[lo:lo + 8])
        ref = C.complete_stable_beam(part, frontier=4, iters=16,
                                     return_boards=False)
        assert (ref.found == got.found[lo:lo + 8]).all()
        assert (ref.best_pop == got.best_pop[lo:lo + 8]).all()
        assert (ref.proved_inconsistent
                == got.proved_inconsistent[lo:lo + 8]).all()


def test_complete_stable_beam_queued_empty_queue():
    """An empty queue returns empty results instead of dividing by
    zero."""
    z = jnp.zeros((0, 64, 2), jnp.uint32)
    res = C.complete_stable_beam_queued(BP.make(state=z, unknown=z))
    assert res.found.shape == (0,) and res.found.dtype == bool
    assert res.best_pop.shape == (0,) and res.best_pop.dtype == np.int32
    assert res.proved_inconsistent.shape == (0,)
    assert res.best is None
