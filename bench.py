#!/usr/bin/env python
"""Headline benchmark: bit-exact 64x64 Life steps/sec on one GPU.

Runs the library's public rollout (``core.step.rollout``: the fused CUDA
kernel on a GPU) and prints ONE JSON line naming the device (platform,
device kind, card count and the card's power limit).  Without a GPU it
exits non-zero and prints no rate: a CPU timing is not a device number.

Measurement methodology:

* the measured program is ONE dispatch that loops the workload M times
  on-device (fori_loop feeding state back through the workload — data
  dependence defeats CSE), so fixed per-dispatch and readback costs are
  paid once per MEASUREMENT;
* timing is fenced by a host readback;
* the per-call cost is the M-difference slope
  (t(M_hi) - t(M_lo)) / (M_hi - M_lo), sampled REPS times; the MEDIAN is
  reported.  If the median is non-positive or the spread of the middle
  samples exceeds SPREAD_LIMIT, an explicit ``error`` JSON is printed —
  never a fabricated value;
* the headline is gated bit for bit: all boards are checked against the
  independent native C oracle.

The same JSON object carries secondary fields — beam-solver, propagate
fixpoint, convolution, catalyst, MPC and orbit rates — each measured
with the same discipline and each isolated in its own try/except so a
failing secondary can never corrupt the headline (it degrades to a
``<name>_error`` string field).  Reference anchors: LifeStable.hpp:718
and :1414 (solver), LifeAPI.hpp:1293 (convolve).

Baseline: the reference C++ LifeAPI ``Step`` measured at 5.55e6 steps/s on
one Xeon 2.1 GHz core (BASELINE.md).  ``vs_baseline`` is the speedup.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

import jax

from lifeapi_tpu.core import step as S
from lifeapi_tpu.utils import compile_cache

BASELINE_STEPS_PER_SEC = 5.55e6  # reference LifeAPI.hpp:1196-1216, 1 CPU core
BASELINE_SOLVES_PER_SEC = 3333.0  # ~0.3 ms/solve CPU DFS, LifeStable.hpp:1414
BASELINE_FIXPOINTS_PER_SEC = 6.7e5  # LifeStable.hpp:718-729 (BASELINE.md)
BASELINE_CONV_PER_SEC = 1.0e7  # LifeAPI.hpp:1293 sparse best case
BASELINE_ORBIT_PER_SEC = 1.85e5  # reference GetOctoHash (benches/ref_harness)

M_LO, M_HI = 1, 1025  # on-device kernel-call loop counts; slope over the diff
REPS = 5              # slope samples per round; median reported
ROUNDS = 3            # re-measure on an unstable round (jitter is bursty)
SPREAD_LIMIT = 1.5    # max/min over the inner samples (outliers trimmed)

# soft wall-clock budget: secondaries are skipped (never the headline)
# once this much time has elapsed
TIME_BUDGET_S = 30 * 60


def _median_slope(timed, m_lo, m_hi, reps=REPS, rounds=ROUNDS,
                  spread_limit=SPREAD_LIMIT):
    """Median M-difference slope with the round-3 stability discipline.

    Returns ``(median_seconds_per_call, spread, None)`` on success or
    ``(None, None, diagnostics_dict)`` when no round achieves a positive
    median with bounded spread — callers must then report an explicit
    error, never a fabricated value."""
    timed(m_lo)  # compile both programs + warm dispatch
    timed(m_hi)
    all_slopes = []
    for _ in range(rounds):
        slopes = []
        for _ in range(reps):
            t_lo = timed(m_lo)
            t_hi = timed(m_hi)
            slopes.append((t_hi - t_lo) / (m_hi - m_lo))
        all_slopes.append([s * 1e3 for s in slopes])
        med = statistics.median(slopes)
        inner = sorted(slopes)[1:-1]
        if med > 0 and inner and min(inner) > 0:
            spr = max(inner) / min(inner)
        else:
            spr = float("inf")
        if med > 0 and spr <= spread_limit:
            return med, spr, None
    return None, None, {"slopes_ms_rounds": all_slopes}


def _headline(result):
    import functools

    B, T = 8192, 512

    rng = np.random.default_rng(0)
    boards0 = rng.integers(0, 2**32, size=(B, 64, 2), dtype=np.uint32)
    boards = jax.device_put(boards0)
    run = jax.jit(lambda b: S.rollout(b, T))

    @functools.partial(jax.jit, static_argnames=("m",))
    def run_m(b, m):
        # ONE dispatch: m rollouts chained on-device; the carry is the
        # board state itself, so no call can be CSE'd away
        return jax.lax.fori_loop(0, m, lambda i, c: S.rollout(c, T), b)

    # bit-exactness: the native C oracle steps the same boards T
    # generations, and ALL B boards are compared
    try:
        from lifeapi_tpu.native import build as nb

        ours = nb.packed32_to_packed64(np.asarray(run(boards)))
        oracle = nb.step_packed64(nb.packed32_to_packed64(boards0), steps=T)
        bit_exact = bool((ours == oracle).all())
    except Exception as exc:  # oracle build failure should not kill the bench
        bit_exact = f"oracle unavailable: {exc}"

    if bit_exact is not True:
        result["error"] = f"bit-exactness gate failed: {bit_exact}"
        result["value"] = 0.0
        result["vs_baseline"] = 0.0
        return False

    def timed(m):
        t0 = time.perf_counter()
        np.asarray(run_m(boards, m))  # host readback = execution fence
        return time.perf_counter() - t0

    median, spread, diag = _median_slope(timed, M_LO, M_HI)
    if median is None:
        result["error"] = (
            f"no measurement round achieved positive median slope with "
            f"spread <= {SPREAD_LIMIT}x ({ROUNDS} rounds x {REPS} "
            f"samples) — never reporting a fabricated value"
        )
        result["value"] = 0.0
        result["vs_baseline"] = 0.0
        result.update(diag)
        return False

    steps_per_sec = B * T / median
    result["value"] = steps_per_sec
    result["vs_baseline"] = steps_per_sec / BASELINE_STEPS_PER_SEC
    result["spread"] = round(spread, 3)
    result["samples"] = REPS
    result["bit_exact_boards"] = B
    return True


def _secondary_beam(result):
    """CompleteStable beam-solver rate (on-device fori_loop
    M-differencing, plus the end-to-end API rates).  Anchor:
    LifeStable.hpp:1414-1458."""
    import jax.numpy as jnp

    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.stable import bitplane as BP
    from lifeapi_tpu.stable import complete as C

    B = 8192
    F = 4
    iters = 24
    m_lo, m_hi = 1, 9

    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)])
    unknown = (board.zoi(eater) & ~eater) | hide
    bst = BP.make(
        state=jnp.broadcast_to(eater & ~hide, (B, 64, 2)),
        unknown=jnp.broadcast_to(unknown, (B, 64, 2)),
    )

    import functools

    @functools.partial(jax.jit, static_argnames=("m",))
    def run_m(bst, m):
        def body(i, acc):
            # roll to an equivalent (torus-shifted) problem; the
            # accumulator consumes the result so no call is CSE'd away
            sti = BP.BitStable(
                jnp.roll(bst.state, i, axis=-2),
                jnp.roll(bst.unknown, i, axis=-2),
                bst.ruled,
            )
            found, _, pop, proved = C.beam_search_jnp(sti, F, iters, True)
            return (acc + jnp.sum(found, dtype=jnp.uint32)
                    + jnp.sum(pop.astype(jnp.uint32))
                    + jnp.sum(proved, dtype=jnp.uint32))

        return jax.lax.fori_loop(0, m, body, jnp.uint32(0))

    def timed(m):
        t0 = time.perf_counter()
        out = run_m(bst, m)
        np.asarray(out)
        return time.perf_counter() - t0

    median, spread, _ = _median_slope(timed, m_lo, m_hi)
    if median is None:
        result["beam_solves_error"] = "unstable measurement (spread gate)"
        return
    rate = B / median
    result["beam_solves_per_sec"] = rate
    result["beam_vs_baseline"] = rate / BASELINE_SOLVES_PER_SEC
    result["beam_spread"] = round(spread, 3)

    # end-to-end API rates: median of 5 full complete_stable_beam calls
    # (dispatch + single readback included) — the numbers users get.
    # ``compact`` is the found/pop/proved-only readback (12 B/problem,
    # what mask-style callers like weld.unweldable_mask pay).
    for tag, kwargs in (("e2e", dict(dense=False)),
                        ("e2e_compact", dict(return_boards=False))):
        res = C.complete_stable_beam(bst, frontier=F, iters=iters, **kwargs)
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = C.complete_stable_beam(bst, frontier=F, iters=iters,
                                         **kwargs)
            samples.append(time.perf_counter() - t0)
        dt = statistics.median(samples)
        result[f"beam_solves_per_sec_{tag}"] = B / dt
    result["beam_found_fraction"] = float(np.asarray(res.found).mean())

    # queued multi-batch e2e: K chunks of B problems in ONE dispatch + ONE
    # compact readback — the path for bulk solver users
    # (stable.complete.complete_stable_beam_queued)
    K = 16
    big = BP.BitStable(
        jnp.broadcast_to(bst.state[:1], (K * B, 64, 2)),
        jnp.broadcast_to(bst.unknown[:1], (K * B, 64, 2)),
        tuple(jnp.broadcast_to(r[:1], (K * B, 64, 2)) for r in bst.ruled),
    )
    qres = C.complete_stable_beam_queued(
        big, chunk=B, frontier=F, iters=iters)
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        qres = C.complete_stable_beam_queued(
            big, chunk=B, frontier=F, iters=iters)
        samples.append(time.perf_counter() - t0)
    dt = statistics.median(samples)
    result["beam_solves_per_sec_e2e_queued"] = K * B / dt
    result["beam_queued_problems"] = K * B
    result["beam_queued_found_fraction"] = float(qres.found.mean())


def _secondary_propagate(result):
    """Propagate fixpoints/s (stable.bitplane.propagate) at the DEFAULT
    API config (B=4096, 2-ring eater), via M-differencing.  Anchor:
    LifeStable.hpp:718-729."""
    import functools

    import jax.numpy as jnp

    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.stable import bitplane as BP

    B = 4096
    m_lo, m_hi = 1, 257

    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    unknown = board.zoi(board.zoi(eater)) & ~eater
    bst = BP.make(
        state=jnp.broadcast_to(eater, (B, 64, 2)),
        unknown=jnp.broadcast_to(unknown, (B, 64, 2)),
    )

    @functools.partial(jax.jit, static_argnames=("m",))
    def run_m(bst, m):
        def body(i, acc):
            sti = BP.BitStable(
                jnp.roll(bst.state, i, axis=-2),
                jnp.roll(bst.unknown, i, axis=-2),
                bst.ruled,
            )
            res = BP.propagate(sti)
            return acc + jnp.sum(res.stable.ruled[0], dtype=jnp.uint32)

        return jax.lax.fori_loop(0, m, body, jnp.uint32(0))

    def timed(m):
        t0 = time.perf_counter()
        out = run_m(bst, m)
        np.asarray(out)
        return time.perf_counter() - t0

    median, spread, _ = _median_slope(timed, m_lo, m_hi)
    if median is None:
        result["propagate_fixpoints_error"] = "unstable measurement"
        return
    rate = B / median
    result["propagate_fixpoints_per_sec"] = rate
    result["propagate_vs_baseline"] = rate / BASELINE_FIXPOINTS_PER_SEC
    result["propagate_spread"] = round(spread, 3)


def _secondary_convolve_sparse(result):
    """Sparse shift-OR convolve/s with a host-known 7-cell operand — the
    apples-to-apples comparison against the reference's sparse best case
    (LifeAPI.hpp:1293-1370, ~1e7 conv/s)."""
    import functools

    import jax.numpy as jnp

    from lifeapi_tpu.core import board
    from lifeapi_tpu.core import convolve as CV

    B = 4096
    m_lo, m_hi = 1, 2049

    rng = np.random.default_rng(0)
    a = board.from_dense(jnp.asarray(rng.random((B, 64, 64)) < 0.1))
    pat_cells = [tuple(map(int, c))
                 for c in rng.integers(20, 28, size=(7, 2))]

    @functools.partial(jax.jit, static_argnames=("m",))
    def run_m(a, m):
        def body(i, acc):
            ai = jnp.roll(a, i, axis=-2)
            res = CV.convolve_sparse(ai, pat_cells)
            return acc + jnp.sum(res, dtype=jnp.uint32)

        return jax.lax.fori_loop(0, m, body, jnp.uint32(0))

    def timed(m):
        t0 = time.perf_counter()
        out = run_m(a, m)
        np.asarray(out)
        return time.perf_counter() - t0

    median, spread, _ = _median_slope(timed, m_lo, m_hi)
    if median is None:
        result["convolve_sparse_error"] = "unstable measurement"
        return
    rate = B / median
    result["convolve_sparse_per_sec"] = rate
    result["convolve_sparse_vs_baseline"] = rate / BASELINE_CONV_PER_SEC
    result["convolve_sparse_spread"] = round(spread, 3)


def _secondary_convolve_traced(result):
    """Library-entry convolution with TRACED per-board 7-cell operands —
    the reference's sparse best case re-created faithfully (it reads the
    operand at runtime too; LifeAPI.hpp:1284-1370).  Uses the
    population-proportional extraction loop (convolve_sparse_device)."""
    import functools

    import jax.numpy as jnp

    from lifeapi_tpu.core import board
    from lifeapi_tpu.core import convolve as CV

    B = 4096
    m_lo, m_hi = 1, 1025

    rng = np.random.default_rng(0)

    def mk():
        d = np.zeros((B, 64, 64), bool)
        for i in range(B):
            d[i, rng.integers(20, 28, 7), rng.integers(20, 28, 7)] = True
        return board.from_dense(jnp.asarray(d))

    a, b = mk(), mk()

    @functools.partial(jax.jit, static_argnames=("m",))
    def run_m(a, b, m):
        def body(i, acc):
            ai = jnp.roll(a, i, axis=-2)
            res = CV.convolve(ai, b, method="sparse")
            return acc + jnp.sum(res, dtype=jnp.uint32)

        return jax.lax.fori_loop(0, m, body, jnp.uint32(0))

    def timed(m):
        t0 = time.perf_counter()
        out = run_m(a, b, m)
        np.asarray(out)
        return time.perf_counter() - t0

    median, spread, _ = _median_slope(timed, m_lo, m_hi)
    if median is None:
        result["convolve_traced_error"] = "unstable measurement"
        return
    rate = B / median
    result["convolve_traced_per_sec"] = rate
    result["convolve_traced_vs_baseline"] = rate / BASELINE_CONV_PER_SEC
    result["convolve_traced_spread"] = round(spread, 3)


def _secondary_catalyst(result):
    """End-to-end catalyst-search pipeline placements/s (search.py on the
    platform's engine; reference inner loop LifeAPI.hpp:1196 +
    LifeTarget.hpp:53).  Host comparison lives in benches/extra.py
    catalyst."""
    import functools

    import jax.numpy as jnp

    from lifeapi_tpu import search as SR
    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.symmetry import transforms as tr
    from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T

    horizon = 64
    m_lo, m_hi = 1, 1025

    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)
    offsets = SR.candidate_offsets(glider, eater)
    P = int(offsets.shape[0])

    @functools.partial(jax.jit, static_argnames=("m",))
    def run_m(active, offsets, m):
        def body(i, acc):
            res = SR.catalyst_search(
                jnp.roll(active, i, axis=-2), eater, offsets, horizon)
            return acc + jnp.sum(SR.successful_catalysts(res),
                                 dtype=jnp.uint32)

        return jax.lax.fori_loop(0, m, body, jnp.uint32(0))

    def timed(m):
        t0 = time.perf_counter()
        out = run_m(glider, offsets, m)
        np.asarray(out)
        return time.perf_counter() - t0

    median, spread, _ = _median_slope(timed, m_lo, m_hi)
    if median is None:
        result["catalyst_error"] = "unstable measurement"
        return
    result["catalyst_placements_per_sec"] = P / median
    result["catalyst_spread"] = round(spread, 3)


def _secondary_mpc(result):
    """MPC engine solves/s at the literal BASELINE.json config-2 shape:
    horizon-32, 64-candidate adam optimization + bit-exact hard rescore
    (mpc/solver.py).  Same M-differencing discipline as every other
    secondary."""
    import functools

    import jax.numpy as jnp

    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.mpc import CostWeights, MPCProblem, solver
    from lifeapi_tpu.target import LifeTarget

    n_candidates = 64
    horizon = 32
    iters = 100
    m_lo, m_hi = 1, 9

    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 31, 31))
    mask = jnp.zeros((64, 64), bool).at[20:44, 20:44].set(True)
    problem = MPCProblem(
        initial=board.empty(), target=target, horizon=horizon,
        control_mask=mask, weights=CostWeights(),
    )
    logits0 = solver.init_logits(jax.random.key(0), problem, n_candidates)

    @functools.partial(jax.jit, static_argnames=("m",))
    def run_m(lg0, m):
        def body(i, acc):
            # candidate-axis roll varies the data per iteration so no
            # solve can be CSE'd away; compute is iteration-invariant
            lg = jnp.roll(lg0, i, axis=0)
            out, _ = solver.solve_gradient(lg, problem, iters=iters)
            probs = jax.nn.sigmoid(out) * problem.control_mask
            costs, _ = jax.vmap(
                lambda p: solver.hard_score(p, problem))(probs)
            return acc + jnp.min(costs)

        return jax.lax.fori_loop(0, m, body, jnp.float32(0))

    def timed(m):
        t0 = time.perf_counter()
        out = run_m(logits0, m)
        np.asarray(out)
        return time.perf_counter() - t0

    median, spread, _ = _median_slope(timed, m_lo, m_hi)
    if median is None:
        result["mpc_error"] = "unstable measurement"
        return
    rate = n_candidates / median
    result["mpc_solves_per_sec"] = rate
    result["mpc_spread"] = round(spread, 3)


def _secondary_orbit(result):
    """Full 16-transform orbit sweep + on-device 64-bit digests per
    board (packed bit-permutation transforms, symmetry/orbits.py
    fingerprint).  Baseline 1.85e5/s = the measured reference
    GetOctoHash (Symmetry.hpp:774-785, benches/ref_harness)."""
    import functools

    import jax.numpy as jnp

    from lifeapi_tpu.symmetry import orbits as OR
    from lifeapi_tpu.symmetry.transforms import ALL_TRANSFORMS, transform

    B = 4096
    m_lo, m_hi = 1, 257

    rng = np.random.default_rng(0)
    packed = jax.device_put(
        rng.integers(0, 2**32, size=(B, 64, 2), dtype=np.uint32))

    @functools.partial(jax.jit, static_argnames=("m",))
    def run_m(boards, m):
        def body(i, acc):
            bi = jnp.roll(boards, i, axis=-2)
            h = jnp.uint32(0)
            for t in ALL_TRANSFORMS:
                fa, fb = OR.fingerprint(transform(bi, t))
                h = h ^ fa ^ fb
            return acc + jnp.sum(h, dtype=jnp.uint32)

        return jax.lax.fori_loop(0, m, body, jnp.uint32(0))

    def timed(m):
        t0 = time.perf_counter()
        out = run_m(packed, m)
        np.asarray(out)
        return time.perf_counter() - t0

    median, spread, _ = _median_slope(timed, m_lo, m_hi)
    if median is None:
        result["orbit_error"] = "unstable measurement"
        return
    rate = B / median
    result["orbit_sweeps_per_sec"] = rate
    result["orbit_vs_baseline"] = rate / BASELINE_ORBIT_PER_SEC
    result["orbit_spread"] = round(spread, 3)


def _device():
    """{platform, kind, count, power_limit} of the card this runs on."""
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "power_limit": card.stdout.strip().splitlines()[0].split(", ")[-1]
            if card.returncode == 0 and card.stdout.strip() else None}


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found "
                 f"{jax.devices()[0].platform!r} and no GPU")
    compile_cache.enable()
    t_start = time.perf_counter()

    result = {
        "metric": "life_steps_per_sec",
        "value": 0.0,
        "unit": "steps/s",
        "vs_baseline": 0.0,
        "device": _device(),
    }
    try:
        ok = _headline(result)
    except Exception as exc:
        result["error"] = f"headline failed: {exc!r}"
        ok = False

    # secondary fields: each error-isolated so nothing here can corrupt
    # the headline above, and each skipped once the soft time budget is
    # spent
    secondaries = (
        ("beam", _secondary_beam),
        ("mpc", _secondary_mpc),
        ("propagate", _secondary_propagate),
        ("convolve_sparse", _secondary_convolve_sparse),
        ("convolve_traced", _secondary_convolve_traced),
        ("catalyst", _secondary_catalyst),
        ("orbit", _secondary_orbit),
    )
    if ok:
        for name, fn in secondaries:
            if time.perf_counter() - t_start > TIME_BUDGET_S:
                result[f"{name}_skipped"] = "time budget exhausted"
                continue
            try:
                fn(result)
            except Exception as exc:
                result[f"{name}_error"] = repr(exc)[:200]

    print(json.dumps(result))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
