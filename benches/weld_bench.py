#!/usr/bin/env python
"""UnweldableMask end-to-end benchmark (round-2 VERDICT directive #2).

The reference's compound workload (LifeWeld.hpp:247-277, SURVEY.md §3.5):
for every untested relative placement of catalyst B against catalyst A,
weld the two and run a bounded still-life completion; provably
uncompletable placements are marked bad.  This is the closest reference
analog of this library's native "thousands of candidate boards in one
batched call" workload — and was unmeasured until round 3.

Workload: catalysts WITH stripped stators (weld.from_required on the
reference LifeWeldTest fixtures) so the CSP actually has to rebuild a
stator around each placement; plain still-life pairs complete trivially
everywhere and measure nothing.

Reported per configuration:
  * host engine wall-clock (faithful reference loop: one DFS completion
    per offset, 0.05 s budget — LifeWeld.hpp:265)
  * beam engine wall-clock (ALL placements one batched problem set, few
    dispatches) at several beam_iters depths
  * coverage: |beam-proved bad| / |DFS-marked bad| — the beam marks only
    SOUND inconsistency proofs, so coverage <= 1 is expected and the
    speed/coverage tradeoff is the honest result.

Prints one JSON line per row (benches discipline: median-of-k timings,
no fabricated values).
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lifeapi_tpu import weld as W  # noqa: E402
from lifeapi_tpu.core import board, rle  # noqa: E402

# reference LifeWeldTest fixtures (tests/test_weld.py REQUIRED_PAIRS)
CATALYST = (
    "2o$o2bob2o$b3obobo$5bobo$b5ob3o$bo4bo3bo$4bobo2b2o$4b2o!",
    "4o$5o2bo$4o$5o4bo$b5ob5o$b12o$b12o$b12o$4b9o$4b4o!",
)
EATER = ("2b2o$bobo$bo$2o!", "2b2o$b3o$b4o$5o$4o$4o!")


def _weld(pair, dx, dy):
    state = board.move(rle.parse(pair[0]), 20 + dx, 20 + dy)
    required = board.move(rle.parse(pair[1]), 19 + dx, 19 + dy)
    return W.from_required(state, required)


def run_pair(name, a, b, window, beam_iters_list=(24, 96),
             batch_size=4096, host_timeout=0.05):
    """window: dense bool[64, 64] of offsets to test (rest pre-marked
    good) — keeps the host loop tractable while still covering the full
    interaction neighbourhood."""
    good0 = board.from_dense(jnp.asarray(~window))
    inter = np.asarray(board.to_dense(W.interaction_offsets(a, b)))
    n_test = int((window & ~inter).sum())

    t0 = time.perf_counter()
    host_bad = np.asarray(board.to_dense(W.unweldable_mask(
        a, b, starting_good=good0, solve_timeout=host_timeout,
        engine="host")))
    host_s = time.perf_counter() - t0
    host_marked = host_bad & window & ~inter
    n_host = int(host_marked.sum())

    for iters in beam_iters_list:
        for escalate in (False, True):
            # warm (compile) then measure: each engine is called twice
            stats = None
            for rep in range(2):
                t0 = time.perf_counter()
                out = W.unweldable_mask(
                    a, b, starting_good=good0, engine="beam",
                    batch_size=batch_size, beam_iters=iters,
                    escalate=escalate, return_stats=True)
                beam_mask, stats = out
                beam_bad = np.asarray(board.to_dense(beam_mask))
                beam_s = time.perf_counter() - t0
            beam_marked = beam_bad & window & ~inter
            n_beam = int(beam_marked.sum())
            n_both = int((beam_marked & host_marked).sum())
            unsound = int((beam_marked & ~host_marked).sum())
            tag = "esc" if escalate else ""
            if escalate:
                missed = [tuple(map(int, xy)) for xy in
                          np.argwhere(host_marked & ~beam_marked)]
                cls = _classify_missed(a, b, missed)
            else:
                cls = None
            print(json.dumps({
                "metric": f"unweldable_{name}_beam{iters}{tag}",
                "value": host_s / beam_s if beam_s > 0 else 0.0,
                "unit": "x host wall-clock",
                "beam_seconds": round(beam_s, 4),
                "host_seconds": round(host_s, 4),
                "escalated": escalate,
                "placements_tested": n_test,
                "dfs_marked_bad": n_host,
                "beam_proved_bad": n_beam,
                "coverage": round(n_both / n_host, 4) if n_host else None,
                "beam_marked_not_in_dfs": unsound,
                "missed_dfs_marks_classified": cls,
                "tier_stats": stats,
                "note": "coverage = |beam-proved AND DFS-marked| / "
                        "DFS-marked; beam marks are sound proofs (never "
                        "wrong), DFS marks are 0.05s-budget refutations; "
                        "beam_marked_not_in_dfs are sound proofs the DFS "
                        "budget timed out on; escalated rows add the "
                        "deep-F=8-beam + host-DFS fallback tiers (weld.py)",
            }), flush=True)


def _classify_missed(a, b, missed):
    """DFS-marked placements the escalated beam did not mark: each is
    either PROVEN WELDABLE (a deep F=8 beam finds a completion — the
    0.05 s DFS budget-refutation was wrong: our complete_stable, like
    the reference loop LifeStable.hpp:1414-1458, can report INCONSISTENT
    from a ring-restricted search area when the budget expires), a
    SOUND miss (a 1 s DFS confirms inconsistency), or UNCONFIRMED
    (neither engine determines it in 1 s)."""
    from lifeapi_tpu.stable import host as HO

    if not missed:
        return {"proved_weldable": 0, "sound_missed": 0, "unconfirmed": 0}
    cap = -(-len(missed) // 128) * 128
    padded = missed + [missed[0]] * (cap - len(missed))
    sts = W._build_placements(a, b, jnp.asarray(padded, jnp.int32))
    from lifeapi_tpu.stable import complete as C

    res = C.complete_stable_beam(sts, frontier=8, iters=768,
                                 minimise=False, return_boards=False)
    found = np.asarray(res.found)[:len(missed)]
    out = {"proved_weldable": int(found.sum()), "sound_missed": 0,
           "unconfirmed": 0}
    rest = [i for i, f in enumerate(missed) if not found[i]]
    if rest:
        states = np.asarray(sts.state)
        unknowns = np.asarray(sts.unknown)
        ruleds = np.asarray(sts.ruled)
        for i in rest:
            hst = HO.HostStable(states[i].copy(), unknowns[i].copy(),
                                ruleds[i].copy())
            r, _ = C.complete_stable(hst, timeout=1.0, minimise=False)
            if r == C.CompletionResult.INCONSISTENT:
                out["sound_missed"] += 1
            else:
                out["unconfirmed"] += 1
    return out


def main():
    which = sys.argv[1:] or ["catxeater", "eaterxeater"]

    # placements are torus displacements: cell (x, y) = shift of b by
    # (x, y) with negatives wrapped.  Cover displacements [-20, 23]^2
    # around the overlap region (patterns sit at (20, 20)).
    ax = (np.arange(64) + 20) % 64 < 44
    window = ax[:, None] & ax[None, :]

    if "catxeater" in which:
        a = _weld(CATALYST, 0, 0)
        b = _weld(EATER, 0, 0)
        run_pair("catxeater", a, b, window)
    if "eaterxeater" in which:
        a = _weld(EATER, 0, 0)
        b = _weld(EATER, 0, 0)
        run_pair("eaterxeater", a, b, window)


if __name__ == "__main__":
    main()
