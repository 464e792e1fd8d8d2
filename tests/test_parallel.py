import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.mpc import CostWeights, MPCProblem, solver
from lifeapi_tpu.parallel import elite, make_mesh
from lifeapi_tpu.target import LifeTarget

N = 64


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(n_scenario=4, n_candidate=2)


def _problem(horizon=4):
    target_state = board.move(rle.parse("2o$2o!"), 31, 31)
    target = LifeTarget.from_state(target_state)
    mask = jnp.zeros((N, N), bool).at[28:36, 28:36].set(True)
    return MPCProblem(
        initial=board.empty(),
        target=target,
        horizon=horizon,
        control_mask=mask,
        weights=CostWeights(target=1.0, control=0.01),
    )


def test_mesh_shape(mesh8):
    assert mesh8.devices.shape == (4, 2)
    assert mesh8.axis_names == ("scenario", "candidate")


def test_sharded_candidate_solve_matches_local(mesh8):
    problem = _problem()
    key = jax.random.key(0)
    logits0 = solver.init_logits(key, problem, 16)
    best_cost, best_probs, all_costs = elite.sharded_candidate_solve(
        problem, logits0, mesh8, iters=60, topk=2
    )
    assert all_costs.shape == (16,)
    assert float(best_cost) == float(jnp.min(all_costs))
    # the sharded elite is a real solution: rescoring it reproduces the cost
    cost_again, _ = solver.hard_score(best_probs, problem)
    assert float(cost_again) == float(best_cost)


def test_sharded_scenario_sweep(mesh8):
    problem = _problem()
    initials = jnp.broadcast_to(board.empty(), (8, N, 2))
    per_scenario, champion = elite.sharded_scenario_sweep(
        initials,
        problem.target,
        problem.horizon,
        problem.control_mask,
        mesh8,
        jax.random.key(1),
        candidates_per_scenario=4,
        iters=40,
        weights=problem.weights,
    )
    assert per_scenario.shape == (8,)
    assert float(champion) == float(jnp.min(per_scenario))


def test_sharded_beam_complete_matches_unsharded(mesh8):
    from lifeapi_tpu.stable import bitplane as BP
    from lifeapi_tpu.stable import complete as C

    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)])
    unknown = (board.zoi(eater) & ~eater) | hide
    B = 8
    bst = BP.make(
        state=jnp.broadcast_to(eater & ~hide, (B, 64, 2)),
        unknown=jnp.broadcast_to(unknown, (B, 64, 2)),
    )
    found, best, pop, champ, champ_pop = elite.sharded_beam_complete(
        bst, mesh8, frontier=4, iters=16, minimise=True
    )
    # identical problems on every shard must give identical verdicts, and
    # they must match the unsharded jnp beam
    ref_found, ref_best, ref_pop, _ = C.beam_search_jnp(
        bst, frontier=4, iters=16, minimise=True
    )
    assert (np.asarray(found) == np.asarray(ref_found)).all()
    assert (np.asarray(pop) == np.asarray(ref_pop)).all()
    assert (np.asarray(best) == np.asarray(ref_best)).all()
    # the champion exchange returns one of the found boards with its pop
    assert np.asarray(found).all()
    assert int(champ_pop) == int(np.asarray(ref_pop).min())
    assert (np.asarray(champ) == np.asarray(ref_best)[0]).all()


def test_sharded_beam_two_phase(mesh8):
    """two_phase: the champion exchange bounds a second pass; the refined
    champion can only be at least as good, per-problem outputs keep
    phase-1 semantics, and the champion stays a valid still life."""
    from lifeapi_tpu.core.step import step as life_step
    from lifeapi_tpu.stable import bitplane as BP

    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)])
    unknown = (board.zoi(eater) & ~eater) | hide
    B = 8
    bst = BP.make(
        state=jnp.broadcast_to(eater & ~hide, (B, 64, 2)),
        unknown=jnp.broadcast_to(unknown, (B, 64, 2)),
    )
    f1, b1, p1, c1, cp1 = elite.sharded_beam_complete(
        bst, mesh8, frontier=4, iters=16, minimise=True
    )
    f2, b2, p2, c2, cp2 = elite.sharded_beam_complete(
        bst, mesh8, frontier=4, iters=16, minimise=True, two_phase=True
    )
    assert (np.asarray(f1) == np.asarray(f2)).all()
    assert (np.asarray(p1) == np.asarray(p2)).all()
    assert (np.asarray(b1) == np.asarray(b2)).all()
    assert int(cp2) <= int(cp1)
    champ = jnp.asarray(np.asarray(c2))
    assert bool(board.equal(life_step(champ), champ))
    assert int(board.population(champ)) == int(cp2)


def test_sharded_rollout(mesh8):
    from lifeapi_tpu.core import step as S

    glider = board.move(rle.parse("bob$2bo$3o!"), 20, 20)
    B = 16
    boards = jnp.broadcast_to(glider, (B, 64, 2))
    finals, total_pop = elite.sharded_rollout(boards, steps=6, mesh=mesh8)
    expect = S.step_n(glider, 6)
    assert (np.asarray(finals) == np.asarray(jnp.broadcast_to(
        expect, (B, 64, 2)))).all()
    assert int(total_pop) == 5 * B


def test_sharded_catalyst_search_matches_single(mesh8):
    """Sharded placement sweep == single-device search, hit for hit."""
    import jax.numpy as jnp

    from lifeapi_tpu import search as SR
    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.parallel import elite
    from lifeapi_tpu.symmetry import transforms as tr
    from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T

    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)
    offsets = jnp.asarray(
        [[dx, dy] for dx in range(-8, 8) for dy in range(-8, 8)],
        dtype=jnp.int32)
    inter, rec, hits = elite.sharded_catalyst_search(
        glider, eater, offsets, 100, mesh8)
    ref = SR.catalyst_search(glider, eater, offsets, 100, engine="xla")
    assert int(hits) == int(np.asarray(
        SR.successful_catalysts(ref)).sum())
    assert (np.asarray(inter) == np.asarray(ref.interacted)).all()
    assert (np.asarray(rec) == np.asarray(ref.recovered)).all()


def test_sharded_beam_matches_unsharded_beam(mesh8):
    """Per-problem results of the sharded beam equal the single-device
    complete_stable_beam on the same problems (pure data parallelism)."""
    from lifeapi_tpu.stable import bitplane as BP
    from lifeapi_tpu.stable import complete as C

    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20)])
    unknown = (board.zoi(eater) & ~eater) | hide
    B = 16
    bst = BP.make(
        state=jnp.stack([jnp.roll(eater & ~hide, i, axis=-2)
                         for i in range(B)]),
        unknown=jnp.stack([jnp.roll(unknown, i, axis=-2) for i in range(B)]),
    )
    found, best, pop, _, champ_pop = elite.sharded_beam_complete(
        bst, mesh8, frontier=2, iters=6, minimise=True)
    ref = C.complete_stable_beam(bst, frontier=2, iters=6, minimise=True,
                                 dense=False)
    assert (np.asarray(found) == ref.found).all()
    assert (np.asarray(pop) == ref.best_pop).all()
    assert (np.asarray(best) == ref.best).all()
    assert int(champ_pop) == int(ref.best_pop[ref.found].min())
