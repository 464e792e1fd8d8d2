"""Batched catalyst / placement search.

The reference is the substrate for Bellman/Barrister-style catalyst
searches: place a candidate catalyst near an active reaction, step, and
keep placements where the catalyst perturbs the reaction and then recovers
(SURVEY.md intro).  The reference tests placements one at a time; here all
placements advance together as one batch on the fused step kernel, with
interaction prediction pruning the placement grid first.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import platform
from .core import board as B
from .core import convolve as conv
from .core import step as S
from .target import LifeTarget


class PlacementResult(NamedTuple):
    offsets: jax.Array  # int32[P, 2] candidate (dx, dy)
    interacted: jax.Array  # bool[P] catalyst was perturbed at some point
    recovered: jax.Array  # bool[P] catalyst present again at the end
    reaction_changed: jax.Array  # bool[P] the reaction differs from baseline
    final: jax.Array  # packed uint32[P, 64, 2] final boards


def candidate_offsets(active, catalyst, search_area=None):
    """Offsets worth trying: all translations inside the search area that
    do NOT interact with the active pattern at generation 0 (immediate
    collisions are useless; reference search programs mask them with
    InteractionOffsets, LifeAPI.hpp:1066)."""
    immediate = conv.interaction_offsets(active, catalyst)
    area = search_area if search_area is not None else B.full()
    ok = area & ~immediate
    import numpy as np

    cells = B.on_cells(ok)
    return jnp.asarray(np.asarray(cells, dtype=np.int32).reshape(-1, 2))


def catalyst_search(active, catalyst, offsets, horizon, recovery_target=None,
                    batch=None, engine=None):
    """Try every placement: roll the union forward, require the catalyst to
    interact within the horizon and be recovered at the end.

    active: packed board of the reaction; catalyst: packed board;
    offsets: int32[P, 2].  Returns a PlacementResult.  Fully batched and
    jit friendly.

    ``engine`` (see lifeapi_tpu.platform): ``"cuda"`` runs the whole
    horizon in one fused kernel (ops/step_cuda.catalyst_rollout), boards
    in registers across generations; ``"xla"`` is the portable scan;
    ``None`` picks the platform's engine.  Both are bit-exact
    (tests/test_search.py)."""
    if recovery_target is None:
        recovery_target = LifeTarget.from_state(catalyst)

    # per-placement translation via conditional static rolls
    # (board.move_dyn): a vmap of B.move over traced offsets lowers to
    # per-board gathers, which dominated the fused pipeline's
    # wall-clock (round-4 profile)
    P = offsets.shape[0]
    dx, dy = offsets[:, 0], offsets[:, 1]

    def place_all(pk):
        return B.move_dyn(jnp.broadcast_to(pk, (P, 64, 2)), dx, dy)

    placed = place_all(catalyst)
    boards = placed | active

    target_wanted = place_all(recovery_target.wanted)
    target_unwanted = place_all(recovery_target.unwanted)

    # hoisted loop invariants: XLA does not move computations out of a
    # while/scan body, and the baseline reaction is placement-independent
    # — step it ONCE per generation (not per placement)
    placed_zoi = B.zoi(placed)

    if platform.step_engine(engine) == platform.CUDA:
        from .ops import step_cuda

        final, interacted, base_final = step_cuda.catalyst_rollout(
            boards, active, placed, placed_zoi, horizon)
    else:
        def body(carry, _):
            cur, baseline, interacted = carry
            nxt = S.step(cur)
            base_nxt = S.step(baseline)
            # catalyst perturbed: cells differ from (baseline | catalyst)
            diff = (nxt ^ (base_nxt | placed)) & placed_zoi
            interacted = interacted | ~B.is_empty(diff)
            return (nxt, base_nxt, interacted), None

        interacted0 = jnp.zeros(offsets.shape[0], bool)
        (final, base_final, interacted), _ = jax.lax.scan(
            body, (boards, active, interacted0), None, length=horizon,
        )

    # recovered: wanted cells ON, unwanted OFF at the end
    missing = target_wanted & ~final
    spurious = target_unwanted & final
    recovered = B.is_empty(missing) & B.is_empty(spurious)

    reaction_changed = ~B.equal(final & ~target_wanted, base_final & ~target_wanted)

    return PlacementResult(offsets, interacted, recovered, reaction_changed, final)


def successful_catalysts(result: PlacementResult):
    """Placements that interacted AND recovered — the search hits."""
    return result.interacted & result.recovered


def catalyst_search_all_orientations(active, catalyst, offsets, horizon,
                                     recovery_target=None):
    """Sweep every distinct D8 orientation of the catalyst (symmetry orbit
    representatives) over the placement grid; returns a list of
    (transform, PlacementResult) pairs.  The per-orientation searches are
    batched; orientations iterate on the host (<= 8)."""
    import numpy as np

    from .symmetry import orbits
    from .symmetry import transforms as tr

    base_bounds = np.asarray(B.xy_bounds(catalyst))
    results = []
    for t in orbits.symmetry_orbit_representatives(catalyst):
        oriented = tr.transform(catalyst, t)
        # re-anchor the rotated pattern at the original bounding-box corner
        # so the offset grid stays relative to the same location
        bo = np.asarray(B.xy_bounds(oriented))
        oriented = B.move(oriented, int(base_bounds[0] - bo[0]),
                          int(base_bounds[1] - bo[1]))
        rt = None
        if recovery_target is not None:
            rt = recovery_target.transformed(t)
            rt = rt._replace(
                wanted=B.move(rt.wanted, int(base_bounds[0] - bo[0]),
                              int(base_bounds[1] - bo[1])),
                unwanted=B.move(rt.unwanted, int(base_bounds[0] - bo[0]),
                                int(base_bounds[1] - bo[1])),
            )
        results.append(
            (t, catalyst_search(active, oriented, offsets, horizon, rt))
        )
    return results
