#!/usr/bin/env python
"""The full Bellman-style workflow, end to end — the reference's actual
use-case, composed from every layer of the framework:

1. **Catalyst search** (search.py): find a placement of an eater that
   interacts with an incoming glider and recovers.
2. **Weld** (weld.py): strip the eater's stator, recording frozen
   neighbour counts (``from_required``, LifeWeld.hpp:133-159).
3. **Reaction-constrained completion** (``to_stable_with_history``,
   LifeWeld.hpp:327-400): replay the reaction, restricting still-life
   options so the required births happen and spurious ones don't, then
   complete a stator with the solver.
4. **Verify bit-exactly**: the completed background + the glider stepped
   through the whole horizon must consume the glider and recover.

Run from the repo root:  python examples/bellman_pipeline.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lifeapi_tpu import search as SR  # noqa: E402
from lifeapi_tpu import weld as W  # noqa: E402
from lifeapi_tpu.core import board, rle  # noqa: E402
from lifeapi_tpu.core.step import step_n  # noqa: E402
from lifeapi_tpu.stable import complete as C  # noqa: E402
from lifeapi_tpu.stable import host as HO  # noqa: E402
from lifeapi_tpu.symmetry import transforms as tr  # noqa: E402
from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T  # noqa: E402
from lifeapi_tpu.utils import compile_cache  # noqa: E402

EATER = "2b2o$bobo$bo$2o!"
# the eater's required (non-stator) cells, at a (-1, -1) relative offset
# (the reference LifeWeldTest eater fixture)
EATER_REQ = "2b2o$b3o$b4o$5o$4o$4o!"
HORIZON = 64


def build(pat, pre_dx=0, pre_dy=0, dx=0, dy=0):
    b = board.move(rle.parse(pat), pre_dx, pre_dy)
    b = tr.transform(b, T.Rotate270)
    return board.move(b, 24 + dx, 24 + dy)


def main():
    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)

    # 1. catalyst search: all interacting placements, keep the recoverers
    eater0 = build(EATER)
    offsets = SR.candidate_offsets(glider, eater0)
    res = SR.catalyst_search(glider, eater0, offsets, HORIZON)
    hits = np.asarray(SR.successful_catalysts(res))
    offs = np.asarray(offsets)
    assert hits.any(), "no recovering placement found"
    dx, dy = (int(v) for v in offs[hits.argmax()])
    print(f"catalyst search: {int(hits.sum())} recovering placements; "
          f"using offset ({dx}, {dy})")

    catalyst = build(EATER, dx=dx, dy=dy)
    required = build(EATER_REQ, pre_dx=-1, pre_dy=-1, dx=dx, dy=dy)

    # 2. strip the stator into frozen counts
    w = W.from_required(catalyst, required)
    assert bool(W.step(w).equal(w)), "weld must be step-invariant"
    stripped = int(board.population(catalyst & ~w.state))
    print(f"weld: stripped {stripped} stator cells into frozen counts")

    # 3. replay the reaction, restrict options, complete a stator.
    # Keep the search area local to the catalyst: the glider's flight
    # path must stay OFF (it's background the reaction crosses).
    stab = W.to_stable_with_history(w, glider, HORIZON)
    area = board.big_zoi(catalyst)
    from lifeapi_tpu.stable import propagate as P

    stab = P.set_off(stab, board.to_dense(~area & ~w.state))
    host_st = HO.HostStable(
        np.asarray(stab.state), np.asarray(stab.unknown),
        np.asarray(stab.ruled))
    result, best = C.complete_stable(host_st, timeout=20.0, minimise=True)
    assert result == C.CompletionResult.COMPLETED, result
    background = board.from_dense(jnp.asarray(best))
    print(f"completion: still life of pop {int(board.population(background))} "
          f"(original catalyst pop {int(board.population(catalyst))})")

    # 4. the money check: background alone is stable, and background +
    # glider consumes the glider and recovers bit-exactly
    assert bool(board.equal(step_n(background, 1), background))
    final = step_n(background | glider, HORIZON)
    assert bool(board.equal(final, background)), (
        "reaction on the completed background failed to recover")
    print(f"verified: glider consumed, background recovered bit-exactly "
          f"after {HORIZON} generations")
    print(rle.to_rle(background))

    # 5. the batched form: every recovering placement's reaction-
    # constrained completion as ONE batched solver call (the reference
    # solves these one DFS at a time)
    sel = [tuple(int(v) for v in o) for o in offs[hits]]
    sel = sel[:6]  # demo-sized batch
    cats = jnp.stack([build(EATER, dx=ddx, dy=ddy) for ddx, ddy in sel])
    reqs = jnp.stack([build(EATER_REQ, pre_dx=-1, pre_dy=-1, dx=ddx,
                            dy=ddy) for ddx, ddy in sel])
    import jax as _jax

    def make_problems(cats, reqs, glider):
        # the 64-generation constrained replay, vmapped over every
        # placement, eager batched (this demo never jits it: compiling
        # the unrolled replay graph costs more than running it once)
        def one(cat, req):
            wi = W.from_required(cat, req)
            st = W.to_stable_with_history(wi, glider, HORIZON)
            from lifeapi_tpu.stable import propagate as P2

            return P2.set_off(
                st, board.to_dense(~board.big_zoi(cat) & ~wi.state))

        return _jax.vmap(one)(cats, reqs)

    problems = make_problems(cats, reqs, glider)
    bres = C.complete_stable_beam(
        problems, frontier=4, iters=24, minimise=False, dense=False)
    found = np.asarray(bres.found)
    bgs = jnp.asarray(bres.best)
    finals = step_n(bgs | glider, HORIZON)
    ok = np.asarray(_jax.vmap(board.equal)(finals, bgs)) & found
    print(f"batched: {int(found.sum())}/{len(sel)} placements completed "
          f"in one solver call; {int(ok.sum())} verified recovering "
          f"backgrounds")
    assert ok.any()


if __name__ == "__main__":
    compile_cache.enable()
    main()
