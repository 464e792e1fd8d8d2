import numpy as np
import jax.numpy as jnp
import pytest

from lifeapi_tpu import search
from lifeapi_tpu.core import board, rle, step
from lifeapi_tpu.symmetry import transforms as tr
from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T

EATER = "2b2o$bobo$bo$2o!"
GLIDER = "bob$2bo$3o!"


def test_eater_eats_glider():
    """The classic: eater1 placed in a glider's path consumes it and
    recovers.  Verify the batched search finds working placements."""
    from lifeapi_tpu.symmetry import transforms as tr
    from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T

    glider = board.move(rle.parse(GLIDER), 8, 8)
    # orient the eater's hook to face the incoming (+1, +1) glider
    eater = board.move(tr.transform(rle.parse(EATER), T.Rotate270), 24, 24)

    # hand-check one known-good configuration first: glider travels along
    # the (1,1) diagonal; sweep eater offsets along small shifts and let the
    # search decide which ones work
    offsets = jnp.asarray(
        [[dx, dy] for dx in range(-4, 5) for dy in range(-4, 5)],
        dtype=jnp.int32,
    )
    result = search.catalyst_search(glider, eater, offsets, horizon=80)
    hits = search.successful_catalysts(result)
    assert bool(hits.any()), "no eater placement consumed the glider"

    # verify a reported hit end-to-end: final board == eater alone (glider
    # gone), via direct simulation
    idx = int(np.argmax(np.asarray(hits)))
    dx, dy = (int(v) for v in np.asarray(result.offsets[idx]))
    placed = board.move(eater, dx, dy)
    world = glider | placed
    final = step.step_n(world, 80)
    assert bool(board.equal(final, placed)), (dx, dy)


def test_noninteracting_placement_flagged():
    glider = board.move(rle.parse(GLIDER), 5, 5)
    eater = board.move(rle.parse(EATER), 50, 20)  # far off the path
    offsets = jnp.asarray([[0, 0]], dtype=jnp.int32)
    result = search.catalyst_search(glider, eater, offsets, horizon=30)
    assert not bool(result.interacted[0])
    assert bool(result.recovered[0])  # untouched catalyst is "recovered"


def test_candidate_offsets_excludes_immediate():
    e = board.move(rle.parse(EATER), 30, 30)
    area = board.solid_rect(28, 28, 8, 8)
    offs = search.candidate_offsets(e, e, search_area=area)
    # offset (0,0) would overlap the pattern with itself: excluded
    assert not any((int(a), int(b)) == (0, 0) for a, b in np.asarray(offs))


def test_all_orientations_finds_the_working_one():
    from lifeapi_tpu.search import catalyst_search_all_orientations, successful_catalysts

    glider = board.move(rle.parse(GLIDER), 8, 8)
    eater = board.move(rle.parse(EATER), 24, 24)  # unoriented
    offsets = jnp.asarray(
        [[dx, dy] for dx in range(-4, 5) for dy in range(-4, 5)],
        dtype=jnp.int32,
    )
    results = catalyst_search_all_orientations(glider, eater, offsets, horizon=80)
    assert len(results) == 8  # eater has trivial symmetry
    hit_orientations = [t for t, r in results if bool(successful_catalysts(r).any())]
    assert hit_orientations, "no orientation of the eater worked"


@pytest.mark.gpu
def test_catalyst_fused_matches_xla():
    """The fused CUDA catalyst rollout must be bit-exact with the
    portable XLA scan engine on every result field."""
    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)
    offsets = jnp.asarray(
        [[dx, dy] for dx in range(-5, 6) for dy in range(-5, 6)],
        dtype=jnp.int32)
    rx = search.catalyst_search(glider, eater, offsets, horizon=64,
                                engine="xla")
    rf = search.catalyst_search(glider, eater, offsets, horizon=64,
                                engine="cuda")
    for f in ("interacted", "recovered", "reaction_changed", "final"):
        assert (np.asarray(getattr(rx, f)) == np.asarray(getattr(rf, f))).all(), f


@pytest.mark.gpu
def test_catalyst_fused_empty_and_odd_batches():
    """Kernel edge cases: no placements at all, and a batch that does not
    fill a thread block."""
    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)
    for offsets in (jnp.zeros((0, 2), jnp.int32),
                    jnp.asarray([[dx, 3] for dx in range(-4, 3)], jnp.int32)):
        rx = search.catalyst_search(glider, eater, offsets, horizon=40,
                                    engine="xla")
        rf = search.catalyst_search(glider, eater, offsets, horizon=40,
                                    engine="cuda")
        for f in ("interacted", "recovered", "reaction_changed", "final"):
            assert (np.asarray(getattr(rx, f))
                    == np.asarray(getattr(rf, f))).all(), f


def test_catalyst_engine_choice_on_cpu():
    """The default engine on the CPU is XLA; asking for the CUDA kernel
    there raises instead of falling back."""
    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)
    offsets = jnp.asarray([[dx, dx] for dx in range(-3, 4)], jnp.int32)
    rd = search.catalyst_search(glider, eater, offsets, horizon=32)
    rx = search.catalyst_search(glider, eater, offsets, horizon=32,
                                engine="xla")
    for f in ("interacted", "recovered", "reaction_changed", "final"):
        assert (np.asarray(getattr(rx, f)) == np.asarray(getattr(rd, f))).all(), f
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        search.catalyst_search(glider, eater, offsets, horizon=32,
                               engine="cuda")
    with pytest.raises(ValueError, match="engine"):
        search.catalyst_search(glider, eater, offsets, horizon=32,
                               engine="fused")
