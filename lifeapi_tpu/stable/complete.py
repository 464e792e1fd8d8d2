"""Still-life completion search: find a stable background consistent with a
partial board.

Two engines with the same result contract as the reference
``CompleteStable`` (LifeStable.hpp:1340-1458: return *a* valid still life,
minimal population when ``minimise``):

* :func:`complete_stable` — host-side DFS branch-and-bound, a faithful
  counterpart of the reference recursion, running on the NumPy kernel
  mirror.  The correctness oracle and the single-problem API.
* :func:`complete_stable_beam` — the batched engine: a frontier (beam)
  search where thousands of branch candidates propagate per call under
  jit (SURVEY.md section 7 "batched best-first/beam search").
"""

from __future__ import annotations

import enum
import time
from typing import NamedTuple

import numpy as np

from . import options as opt
from .host import HostStable, big_zoi, count9, zoi


class CompletionResult(enum.Enum):
    COMPLETED = 0
    INCONSISTENT = 1
    TIMEOUT = 2


def _first_on(mask):
    xs, ys = np.nonzero(mask)
    if len(xs) == 0:
        return None
    return int(xs[0]), int(ys[0])


def _branch_cell(st: HostStable, settable):
    """Branch-cell heuristic (reference LifeStable.hpp:1377-1391):
    vulnerable first, then cells with exactly 2 then 3 unknowns in their
    window, then anything settable."""
    cell = _first_on(st.vulnerable() & settable)
    if cell is not None:
        return cell
    unk9 = count9(st.unknown)
    cell = _first_on(settable & (unk9 == 2))
    if cell is not None:
        return cell
    cell = _first_on(settable & (unk9 == 3))
    if cell is not None:
        return cell
    return _first_on(settable)


def _branch_cell_win(st: HostStable, sett_w, xs, ys):
    """Windowed ``_branch_cell``: every settable cell lies in the window
    bbox (>= 2 cells from the window edge), where the window-local
    counts and vulnerability bits are exact; candidate ordering matches
    the full-board raw-index order because no candidate exists outside
    the window.  Returns full-board coordinates."""
    def first(mask):
        cell = _first_on(mask)
        if cell is None:
            return None
        return cell[0] + xs.start, cell[1] + ys.start

    cell = first(st.vulnerable_win(xs, ys) & sett_w)
    if cell is not None:
        return cell
    unk9 = count9(st.unknown[xs, ys])
    cell = first(sett_w & (unk9 == 2))
    if cell is not None:
        return cell
    cell = first(sett_w & (unk9 == 3))
    if cell is not None:
        return cell
    return first(sett_w)


class _Search:
    def __init__(self, deadline, minimise, use_seed, seed):
        self.deadline = deadline
        self.minimise = minimise
        self.use_seed = use_seed
        self.seed = seed
        self.best = None
        self.max_pop = np.inf

    def step(self, st: HostStable):
        """Reference ``CompleteStableStep`` (LifeStable.hpp:1340-1412)."""
        while True:  # manual tail call for the ON branch (:1409)
            if time.monotonic() > self.deadline:
                return CompletionResult.TIMEOUT
            ok, _ = st.propagate()
            if not ok:
                return CompletionResult.INCONSISTENT

            current_pop = int(st.state.sum())
            if current_pop >= self.max_pop:
                return CompletionResult.COMPLETED

            win = None if self.use_seed else st.query_window()
            if win is not None and win[0].stop > win[0].start:
                # windowed branch queries (reference strip-kernel
                # counterpart, LifeStable.hpp:731-1249): settable cells
                # all live in the window's bbox, where window-local
                # counts are exact
                xs, ys = win
                rl = st.ruled[xs, ys]
                sett_w = ((rl != 0) & st.unknown[xs, ys]
                          & zoi((rl & opt.DEAD0) != 0))
                if not sett_w.any():
                    self.best = st.state.copy()
                    self.max_pop = current_pop
                    return CompletionResult.COMPLETED
                cell = _branch_cell_win(st, sett_w, xs, ys)
            else:
                dead0_ruled = (st.ruled & opt.DEAD0) != 0
                settable = st.perturbed_unknowns() & zoi(dead0_ruled)
                if not settable.any():
                    self.best = st.state.copy()
                    self.max_pop = current_pop
                    return CompletionResult.COMPLETED

                if self.use_seed:
                    seed_zoi = self.seed.copy()
                    while not (settable & seed_zoi).any():
                        seed_zoi = zoi(seed_zoi)
                    settable = settable & seed_zoi

                cell = _branch_cell(st, settable)
            if cell is None:
                return CompletionResult.INCONSISTENT

            mask = np.zeros_like(st.state)
            mask[cell] = True

            off_branch = st.copy()
            off_branch.set_off(mask)
            result = self.step(off_branch)
            if result == CompletionResult.TIMEOUT:
                return CompletionResult.TIMEOUT
            if not self.minimise and result == CompletionResult.COMPLETED:
                return CompletionResult.COMPLETED

            st.set_on(mask)
            # loop = tail recursion on the ON branch


def complete_stable(st: HostStable, timeout=1.0, minimise=False, use_seed=False,
                    seed=None, strict=False):
    """Reference ``CompleteStable`` (LifeStable.hpp:1414-1458).  Returns
    (CompletionResult, dense bool[64, 64] best still life).

    ``strict``: the reference's ring-growing loop can break on a spent
    budget while holding an INCONSISTENT verdict from a ring-RESTRICTED
    search area — restricting unknowns to the ring forces outside cells
    OFF, so that verdict does not refute the full instance (the round-4
    "DFS marks are budget artifacts" measurement).  With ``strict=True``
    such a verdict degrades to TIMEOUT; INCONSISTENT is then always a
    sound refutation of the full instance.  Default False = faithful
    reference semantics."""
    empty = np.zeros((64, 64), bool)
    if not st.state.any():
        return CompletionResult.COMPLETED, empty
    if not st.unknown.any():
        return CompletionResult.COMPLETED, st.state.copy()

    deadline = time.monotonic() + timeout
    search = _Search(deadline, minimise, use_seed, seed if seed is not None else empty)

    result = CompletionResult.TIMEOUT
    restricted = False
    search_area = zoi(st.state)
    while (st.unknown & ~search_area).any():
        search_area = zoi(search_area)
        copy = st.copy()
        copy.unknown &= search_area
        # direct mutation of ``unknown`` must invalidate the propagation
        # cache: a caller may pass an already-propagated HostStable, and
        # the ring restriction converts unknown->known-off cells OUTSIDE
        # the window the next (windowed) propagate would compute from the
        # shrunken bbox (round-4 advisor finding)
        copy.invalidate()
        restricted = bool((st.unknown & ~search_area).any())
        result = search.step(copy)
        if (search.best is not None and search.best.any()) or time.monotonic() > deadline:
            break
    else:
        copy = st.copy()
        restricted = False
        result = search.step(copy)

    if (strict and restricted
            and result == CompletionResult.INCONSISTENT):
        result = CompletionResult.TIMEOUT

    best_empty = search.best is None or not search.best.any()
    if result == CompletionResult.TIMEOUT and best_empty:
        return CompletionResult.TIMEOUT, empty
    if result == CompletionResult.INCONSISTENT and best_empty:
        return CompletionResult.INCONSISTENT, empty

    if minimise:
        # re-minimise in a little more space (reference uses the BigZOI
        # dilation of the search area, LifeStable.hpp:1451-1456)
        copy = st.copy()
        copy.unknown &= big_zoi(search_area)
        copy.invalidate()
        search.use_seed = True
        search.seed = st.state | (search.best if search.best is not None else empty)
        search.step(copy)

    return CompletionResult.COMPLETED, (
        search.best if search.best is not None else empty
    )



# ---------------------------------------------------------------------------
# Batched beam search
# ---------------------------------------------------------------------------


def _np_to_dense(packed):
    """Host-side packed uint32[..., 64, 2] -> dense bool[..., 64, 64]
    (same bit order as core.board.to_dense; avoids an 8x larger device
    readback)."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = (packed[..., None] >> shifts) & np.uint32(1)
    return bits.reshape(*packed.shape[:-2], 64, 64).astype(bool)


def _np_from_dense(dense):
    """Host-side inverse of :func:`_np_to_dense`."""
    bits = np.asarray(dense, bool).reshape(
        *np.shape(dense)[:-2], 64, 2, 32).astype(np.uint32)
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (bits * weights).sum(axis=-1, dtype=np.uint32)


class BeamResult(NamedTuple):
    found: "np.ndarray"  # bool[B]
    best: "np.ndarray"  # bool[B, 64, 64]
    best_pop: "np.ndarray"  # int32[B]
    # True iff the search ran to exhaustion WITHOUT ever dropping an
    # active candidate (frontier never overflowed) and found nothing: a
    # sound proof the instance has no completion (reference
    # ``CompletionResult::INCONSISTENT``, LifeStable.hpp:186-190).
    proved_inconsistent: "np.ndarray" = None  # bool[B]


def _propagate_frontier(cur):
    """Propagate a [B, F] frontier of BitStables and compute the
    branch-priority level masks of the result.  Returns
    (BitPropagateResult, levels 4-tuple of packed masks)."""
    from . import bitplane as BP

    res = BP.propagate(cur)
    return res, BP.branch_levels(res.stable)


def _first_cell_mask(packed):
    """Isolate the lexicographically first set cell (lowest column, then
    lowest row) of each packed board: word-level argmax + lowest-set-bit,
    no dense 64x64 expansion."""
    import jax.numpy as jnp

    lead = packed.shape[:-2]
    words = packed.reshape(lead + (128,))
    idx = jnp.argmax(words != 0, axis=-1)
    w = jnp.take_along_axis(words, idx[..., None], axis=-1)[..., 0]
    bit = w & (~w + jnp.uint32(1))  # w & -w
    sel = jnp.arange(128, dtype=idx.dtype) == idx[..., None]
    cellw = jnp.where(sel, bit[..., None], jnp.uint32(0))
    return cellw.reshape(lead + (64, 2))


def _seed_restrict(levels, ok, seed):
    """Seed-proximity restriction of the branch-priority masks (reference
    ``useSeed``, LifeStable.hpp:1366-1375): grow the seed's ZOI until it
    touches the settable set, then intersect every level with it.  Runs
    per frontier candidate under jit (bounded while_loop; 32 dilations
    cover the torus).  Lanes with an empty seed are left unrestricted."""
    import jax
    import jax.numpy as jnp

    from ..core import board as BRD

    settable = levels[3]
    has_settable = ~BRD.is_empty(settable) & ok
    seed = jnp.broadcast_to(seed[:, None], settable.shape)
    seed_empty = BRD.is_empty(seed)
    full = jnp.full_like(seed, jnp.uint32(0xFFFFFFFF))
    sz0 = jnp.where(seed_empty[..., None, None], full, seed)

    def grow_mask(sz):
        return has_settable & BRD.is_empty(settable & sz)

    def cond(c):
        sz, it = c
        return jnp.any(grow_mask(sz)) & (it < 33)

    def body(c):
        sz, it = c
        grown = BRD.zoi(sz)
        g = grow_mask(sz)[..., None, None]
        return jnp.where(g, grown, sz), it + 1

    sz, _ = jax.lax.while_loop(cond, body, (sz0, jnp.int32(0)))
    return tuple(lvl & sz for lvl in levels)


def _beam_body(carry, minimise, seed=None):
    """One beam round: propagate every frontier candidate, harvest leaves,
    branch on the heuristic cell, keep the best F children."""
    import jax.numpy as jnp

    from ..core import board as BRD
    from . import bitplane as BP

    cur, active, best, best_pop, found, complete = carry
    B, F = active.shape
    N = 64

    res, levels = _propagate_frontier(cur)
    cur = res.stable
    ok = active & res.consistent
    if seed is not None:
        levels = _seed_restrict(levels, ok, seed)

    pop = BRD.population(cur.state)
    if minimise:
        # population bound (reference LifeStable.hpp:1351-1355)
        ok = ok & ~(pop >= best_pop[:, None])
    else:
        # first-solution mode: stop working on solved problems
        ok = ok & ~found[:, None]

    settable = levels[3]
    is_leaf = ok & BRD.is_empty(settable)

    # record the best leaf of this round per problem
    leaf_pop = jnp.where(is_leaf, pop, jnp.iinfo(jnp.int32).max)
    which = jnp.argmin(leaf_pop, axis=1)
    round_pop = jnp.take_along_axis(leaf_pop, which[:, None], axis=1)[:, 0]
    round_state = jnp.take_along_axis(
        cur.state, which[:, None, None, None], axis=1
    )[:, 0]
    better = round_pop < best_pop
    best = jnp.where(better[:, None, None], round_state, best)
    best_pop = jnp.where(better, round_pop, best_pop)
    found = found | better

    ok = ok & ~is_leaf

    # branch-cell heuristic (reference LifeStable.hpp:1377-1391): first
    # cell of the highest nonempty priority level, picked word-wise on the
    # packed masks (no dense 64x64 expansion)
    chosen = levels[3]
    for lvl in (levels[2], levels[1], levels[0]):
        has = ~BRD.is_empty(lvl)
        chosen = jnp.where(has[..., None, None], lvl, chosen)
    cell_mask = _first_cell_mask(chosen) & jnp.where(
        ok[..., None, None], jnp.uint32(0xFFFFFFFF), jnp.uint32(0)
    )

    off_child = BP.set_off(cur, cell_mask)
    on_child = BP.set_on(cur, cell_mask)

    # 2F candidates -> keep F best (active first, then lower pop)
    cat = lambda a, b: jnp.concatenate([a, b], axis=1)
    cand = BP.BitStable(
        cat(off_child.state, on_child.state),
        cat(off_child.unknown, on_child.unknown),
        tuple(cat(a, b) for a, b in zip(off_child.ruled, on_child.ruled)),
    )
    cand_active = cat(ok, ok)
    cand_pop = cat(pop, pop + 1)
    score = jnp.where(cand_active, cand_pop, jnp.iinfo(jnp.int32).max)
    full_order = jnp.argsort(score, axis=1)
    order = full_order[:, :F]
    take = lambda x: jnp.take_along_axis(
        x, order.reshape(B, F, *([1] * (x.ndim - 2))), axis=1
    )
    cur = BP.BitStable(
        take(cand.state), take(cand.unknown),
        tuple(take(r) for r in cand.ruled),
    )
    active = jnp.take_along_axis(cand_active, order, axis=1)

    # an active candidate beyond capacity was dropped: the search is no
    # longer exhaustive, so a later empty frontier proves nothing
    dropped = jnp.take_along_axis(cand_active, full_order[:, F:], axis=1)
    complete = complete & ~jnp.any(dropped, axis=1)

    return (cur, active, best, best_pop, found, complete)


def _beam_search_core(cur0, active0, best0, best_pop0, found0, seed, iters,
                      minimise, use_seed=False):
    """The jnp beam loop as a pure function (jit- and shard_map-
    composable)."""
    import jax
    import jax.numpy as jnp

    complete0 = jnp.ones(found0.shape, bool)
    carry = (cur0, active0, best0, best_pop0, found0, complete0,
             jnp.int32(0))

    def cond(carry):
        # early exit once every frontier is exhausted (all leaves
        # harvested / pruned) — matches the DFS returning when its
        # stack empties
        active = carry[1]
        it = carry[-1]
        return jnp.any(active) & (it < iters)

    def loop_body(carry):
        *state, it = carry
        out = _beam_body(tuple(state), minimise,
                         seed=seed if use_seed else None)
        return out + (it + 1,)

    return jax.lax.while_loop(cond, loop_body, carry)[:-1]


def beam_search_jnp(bst0, frontier, iters, minimise, seed=None,
                    init_bound=None):
    """Pure-jnp batched beam search over packed BitStable problems —
    composable under jit AND shard_map (the sharded solver path,
    parallel/elite.sharded_beam_complete).  Returns jnp arrays
    ``(found[B], best packed uint32[B, 64, 2], best_pop[B], proved[B])``."""
    import jax.numpy as jnp

    B = bst0.state.shape[0]
    F = frontier
    N = 64

    def tile(x):
        return jnp.broadcast_to(x[:, None], (B, F) + x.shape[1:])

    from . import bitplane as BP

    cur0 = BP.BitStable(
        tile(bst0.state), tile(bst0.unknown),
        tuple(tile(r) for r in bst0.ruled),
    )
    active0 = jnp.zeros((B, F), bool).at[:, 0].set(True)
    best0 = jnp.zeros((B, N, 2), jnp.uint32)
    if init_bound is None:
        best_pop0 = jnp.full((B,), jnp.iinfo(jnp.int32).max, jnp.int32)
    else:
        best_pop0 = jnp.broadcast_to(
            jnp.asarray(init_bound, jnp.int32), (B,))
    found0 = jnp.zeros((B,), bool)
    seed0 = (jnp.zeros((B, N, 2), jnp.uint32) if seed is None
             else jnp.broadcast_to(seed, (B, N, 2)))
    out = _beam_search_core(cur0, active0, best0, best_pop0, found0, seed0,
                            iters, minimise, use_seed=seed is not None)
    _, active, best, best_pop, found, complete = out
    exhausted = ~jnp.any(active, axis=1)
    proved = exhausted & complete & ~found
    return found, best, best_pop, proved


_BEAM_JIT = None


def _beam_jit():
    """The jitted :func:`beam_search_jnp`, built once per process so
    repeated calls with the same shapes reuse the executable."""
    global _BEAM_JIT
    if _BEAM_JIT is None:
        import jax

        _BEAM_JIT = jax.jit(beam_search_jnp,
                            static_argnames=("frontier", "iters", "minimise"))
    return _BEAM_JIT


def complete_stable_beam(stable, frontier=8, iters=192, minimise=True,
                         dense=True, seed=None, init_bound=None,
                         return_boards=True):
    """Batched frontier search over ``[B]`` independent problems.

    Each problem keeps a frontier of up to ``frontier`` candidate partial
    boards; every iteration propagates ALL candidates in one batched
    bit-plane fixpoint (stable/bitplane.py — 64 cells per word pair),
    records completed leaves into a per-problem incumbent
    (population-minimal if ``minimise``), and replaces each active
    candidate by its OFF/ON children on the heuristically chosen branch
    cell.  Children beyond capacity are kept by lowest population.  This
    trades the reference's DFS order for breadth — thousands of branches
    advance per call (SURVEY.md section 7).  The compiled loop is cached
    at module level, so repeated calls with the same shapes reuse the
    executable.

    ``dense=False`` returns ``best`` as a packed uint32[B, 64, 2] board
    instead of dense bools (an 8x smaller readback).

    ``seed`` (packed uint32[B, 64, 2], optional) enables the reference's
    seed-proximity branching (``useSeed``, LifeStable.hpp:1366-1375):
    branch cells are restricted to the smallest ZOI-dilation of the seed
    that touches the settable set, keeping minimise-mode solutions from
    wandering away from the incumbent.  ``init_bound`` starts the
    population bound at a known incumbent (branch and bound): only
    strictly smaller completions count as found.

    ``return_boards=False`` returns ``best=None`` and reads back only
    found/best_pop/proved (12 bytes per problem instead of 524), for mask
    and existence queries (weld.unweldable_mask, coverage sweeps).
    """
    import jax.numpy as jnp

    from ..core import board as BRD
    from . import bitplane as BP

    needs_pack = not (
        hasattr(stable, "ruled") and isinstance(stable.ruled, tuple)
    )
    bst0 = BP.from_dense_stable(stable) if needs_pack else stable
    if init_bound is not None:
        init_bound = jnp.asarray(init_bound, jnp.int32)
    found, best, best_pop, proved = _beam_jit()(
        bst0, frontier, iters, minimise, seed=seed, init_bound=init_bound)
    if not return_boards:
        return BeamResult(np.asarray(found), None, np.asarray(best_pop),
                          np.asarray(proved))
    best_out = BRD.to_dense(best) if dense else best
    return BeamResult(
        np.asarray(found), np.asarray(best_out), np.asarray(best_pop),
        np.asarray(proved),
    )


_QUEUED_JIT = None


def _queued_run(planes, *, chunk, frontier, iters, minimise):
    """Beam search over ``K`` chunks of ``chunk`` problems as one
    ``lax.scan``: ``planes`` are the BitStable planes with a
    [K * chunk] problem axis; returns (found, best_pop, proved), each
    [K, chunk]."""
    import jax

    from . import bitplane as BP

    def body(_, xs):
        bst = BP.BitStable(xs[0], xs[1], tuple(xs[2:]))
        found, _, pop, proved = beam_search_jnp(bst, frontier, iters,
                                                minimise)
        return 0, (found, pop, proved)

    _, out = jax.lax.scan(
        body, 0, tuple(p.reshape(-1, chunk, 64, 2) for p in planes))
    return out


def complete_stable_beam_queued(stable, chunk=8192, frontier=4, iters=24,
                                minimise=True):
    """Beam completion of a whole problem queue in ONE dispatch and ONE
    compact readback (found/pop/proved, 12 B per problem).

    ``stable``: BitStable (or dense StableState) with a [B_total] problem
    axis.  The queue is split into ceil(B_total / chunk) chunks, padded
    with trivial empty problems, and a ``lax.scan`` runs the beam on one
    chunk after another inside one jitted computation, so device memory
    holds one chunk's frontier at a time.  Results equal per-chunk
    ``complete_stable_beam(return_boards=False)`` calls exactly
    (tests/test_beam.py); ``best`` is None."""
    import jax
    import jax.numpy as jnp

    from . import bitplane as BP

    needs_pack = not (
        hasattr(stable, "ruled") and isinstance(stable.ruled, tuple)
    )
    bst = BP.from_dense_stable(stable) if needs_pack else stable
    B_total = bst.state.shape[0]
    if B_total == 0:
        return BeamResult(np.zeros(0, bool), None, np.zeros(0, np.int32),
                          np.zeros(0, bool))
    chunk = min(chunk, B_total)
    pad = -B_total % chunk
    planes = (bst.state, bst.unknown) + tuple(bst.ruled)
    if pad:
        planes = tuple(
            jnp.concatenate([p, jnp.zeros((pad, 64, 2), jnp.uint32)])
            for p in planes)

    global _QUEUED_JIT
    if _QUEUED_JIT is None:
        _QUEUED_JIT = jax.jit(
            _queued_run,
            static_argnames=("chunk", "frontier", "iters", "minimise"))
    found, pop, proved = _QUEUED_JIT(planes, chunk=chunk, frontier=frontier,
                                     iters=iters, minimise=minimise)
    return BeamResult(np.asarray(found).reshape(-1)[:B_total], None,
                      np.asarray(pop).reshape(-1)[:B_total],
                      np.asarray(proved).reshape(-1)[:B_total])


# ---------------------------------------------------------------------------
# Single-hard-instance portfolio search
# ---------------------------------------------------------------------------


class PortfolioResult(NamedTuple):
    found: bool
    best: "np.ndarray"  # packed uint32[64, 2] (original orientation)
    best_pop: int
    found_fraction: float  # fraction of replicas that found a completion


def _build_replicas(state, unknown, dx, dy):
    """Replica boards for one instance: the 16 symmetry transforms cycled
    over the replica axis, then per-replica random torus translations.
    Jittable; returns packed [R, 64, 2] state/unknown."""
    import jax
    import jax.numpy as jnp

    from ..core import board as BRD
    from ..symmetry import transforms as TR

    R = dx.shape[0]
    st16 = jnp.stack([TR.transform(state, t) for t in range(16)])
    un16 = jnp.stack([TR.transform(unknown, t) for t in range(16)])
    idx = jnp.arange(R) % 16
    mover = jax.vmap(BRD.move)
    return mover(st16[idx], dx, dy), mover(un16[idx], dx, dy)


def _portfolio_champion(res, dx, dy):
    """Back-transform the best replica's board to the original
    orientation; returns (best_pop, packed champion) or (None, None)."""
    import jax.numpy as jnp

    from ..core import board as BRD
    from ..symmetry import transforms as TR

    found = np.asarray(res.found)
    if not found.any():
        return None, None
    pops = np.where(found, np.asarray(res.best_pop), np.iinfo(np.int32).max)
    i = int(np.argmin(pops))
    t = int(i % 16)
    back = BRD.move(jnp.asarray(res.best[i]), -int(dx[i]), -int(dy[i]))
    back = TR.transform(back, TR.transform_inverse(t))
    return int(pops[i]), back


def complete_stable_portfolio(state, unknown, key, replicas=256, frontier=4,
                              iters=192, minimise=True, reminimise=True,
                              explore=False, dfs_polish_timeout=None):
    """Batched answer to the reference's deep single-instance DFS
    (LifeStable.hpp:1340-1412 with the strip kernels making one path
    cheap): ONE hard completion problem searched by ``replicas``
    randomized beam replicas in one batched kernel call.

    Replica r solves the instance transformed by symmetry transform
    ``r % 16`` composed with a random torus translation.  Life stability
    is invariant under the D8 transforms and translations, so solutions
    map back exactly; the packed lexicographic first-cell branch
    heuristic sees a different coordinate order per replica, which makes
    the replicas explore genuinely different branch sequences — the
    portfolio equivalent of randomized DFS restarts.

    ``reminimise`` (with ``minimise``) runs a second seeded pass after a
    champion is found — the portfolio counterpart of the reference's
    BigZOI re-search (LifeStable.hpp:1451-1456): unknowns restricted to
    ``big_zoi(state | champion)``, branch cells restricted to the
    champion's proximity (``seed=``).  This closes most of the minimality
    gap between the breadth-first portfolio and the exhaustive DFS
    (round-2 VERDICT weak #5; measured by benches/portfolio_sweep.py).

    ``state``/``unknown``: packed uint32[64, 2].  Returns the
    back-transformed best completion over all replicas.
    """
    import jax
    import jax.numpy as jnp

    from ..core import board as BRD
    from . import bitplane as BP

    kx, ky = jax.random.split(key)
    dx = jax.random.randint(kx, (replicas,), 0, 64)
    dy = jax.random.randint(ky, (replicas,), 0, 64)
    st_r, un_r = jax.jit(_build_replicas)(state, unknown, dx, dy)
    bst = BP.make(state=st_r, unknown=un_r)
    res = complete_stable_beam(
        bst, frontier=frontier, iters=iters, minimise=minimise,
        dense=False,
    )
    best_pop, champ = _portfolio_champion(res, dx, dy)
    if champ is None:
        return PortfolioResult(
            False, np.zeros((64, 2), np.uint32), 0, 0.0
        )
    found_fraction = float(np.asarray(res.found).mean())

    if minimise and reminimise:
        seed_board = state | champ
        un2 = unknown & BRD.big_zoi(seed_board)
        st_r2, un_r2 = jax.jit(_build_replicas)(state, un2, dx, dy)
        seed_r, _ = jax.jit(_build_replicas)(seed_board, un2, dx, dy)
        res2 = complete_stable_beam(
            BP.make(state=st_r2, unknown=un_r2), frontier=frontier,
            iters=iters, minimise=True, dense=False, seed=seed_r,
            init_bound=best_pop,
        )
        pop2, champ2 = _portfolio_champion(res2, dx, dy)
        if pop2 is not None and pop2 < best_pop:
            best_pop, champ = pop2, champ2

    if minimise and explore:
        # basin-diverse explore pass (round-3 VERDICT directive #5): the
        # result on the showcase two-anchor instance is NEGATIVE (still
        # pop 8 at ~3x the portfolio's work, round 4), so it is opt-in; ``dfs_polish_timeout`` is the effective
        # exactness tool.  Mechanism: the
        # seeded re-minimise above polishes the CHAMPION's basin, but a
        # minimal solution can live in a different basin entirely.  Fresh
        # random translations re-randomize every replica's branch order,
        # the FULL original unknown area stays open, and the incumbent
        # bound turns the pass into branch-and-bound: replicas prune as
        # soon as they exceed the champion (reference counterpart: the
        # DFS's global max_pop bound, LifeStable.hpp:1353-1356).
        k3x, k3y = jax.random.split(jax.random.fold_in(key, 2))
        dx3 = jax.random.randint(k3x, (replicas,), 0, 64)
        dy3 = jax.random.randint(k3y, (replicas,), 0, 64)
        st_r3, un_r3 = jax.jit(_build_replicas)(state, unknown, dx3, dy3)
        res3 = complete_stable_beam(
            BP.make(state=st_r3, unknown=un_r3), frontier=frontier,
            iters=iters, minimise=True, dense=False, init_bound=best_pop,
        )
        pop3, champ3 = _portfolio_champion(res3, dx3, dy3)
        if pop3 is not None and pop3 < best_pop:
            best_pop, champ = pop3, champ3

    if minimise and dfs_polish_timeout:
        # optional exactness polish: an incumbent-bounded host DFS
        # (max_pop = champion, so only strict improvements are explored
        # — reference LifeStable.hpp:1353-1356 semantics).  Round-4
        # measurement on the showcase two-anchor instance: the beam
        # passes converge to pop 8 while the bounded DFS reaches the
        # true minimum pop 7 in 7.2 s (vs 19.3 s unbounded) — the
        # champion bound prunes ~2/3 of the recursion.  Off by default:
        # the pure-device portfolio answers in <1 s.
        from .host import HostStable

        hst = HostStable(
            state=_np_to_dense(np.asarray(state)),
            unknown=_np_to_dense(np.asarray(unknown)),
        )
        search = _Search(time.monotonic() + float(dfs_polish_timeout),
                         True, False, np.zeros((64, 64), bool))
        search.max_pop = int(best_pop)
        search.step(hst)
        if search.best is not None and search.best.any():
            pop4 = int(search.best.sum())
            if pop4 < best_pop:
                best_pop = pop4
                champ = _np_from_dense(search.best)

    return PortfolioResult(
        True, np.asarray(champ), best_pop, found_fraction
    )
