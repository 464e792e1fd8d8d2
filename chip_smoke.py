#!/usr/bin/env python
"""Smoke test of the library's main path on one NVIDIA GPU.

Drives every public entry point of the main path once, at the widths the
library's users run, in one process on one card, and checks each result
against an independent reference:

0. device    — JAX must run on a GPU; prints the card and its power limit;
1. rollout   — 8,192 random boards x 512 generations through
               ``core.step.rollout`` (the fused CUDA kernel), bit for bit
               against the native C oracle and ``core.step.step_n``;
2. catalyst  — glider against eater at every candidate offset, horizon
               64: the platform's engine against ``engine="xla"``;
3. mpc       — BASELINE config 2 (horizon 32, 64 candidates, 100 Adam
               iterations) then hard rescoring: hard costs against a C
               oracle re-simulation, the fused and XLA hard paths bit for
               bit, soft costs of the initial controls against the CPU
               at rtol 1e-4;
4. stable    — ``complete_stable_beam_queued`` on 131,072 problems
               (16 chunks of 8,192, frontier 4, 24 iterations) against
               per-chunk beam calls, the C oracle and the host DFS;
5. conv      — ``convolve_counts``, ``convolve`` and
               ``interaction_offsets`` on 4,096 sparse and dense board
               pairs against numpy counts;
6. gpu tests — the ``gpu``-marked tests of tests/ (the CUDA kernels'
               edge cases), run in this process.

Each phase prints its wall time with compile time apart, the
``memory_analysis()`` of its main jitted step and the device's
``peak_bytes_in_use``.  The last line is one JSON object,
``{"ok": true, "device": {...}}``; any failure exits non-zero and prints
no ``"ok": true``.

``--four`` runs instead the sharded paths of ``parallel.elite`` on a mesh
of four GPUs at four times the single-card widths, each against the same
call on a one-card mesh.

    python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

STILL_LIFES = (
    "2o$2o!",                # block
    "2b2o$bobo$bo$2o!",      # eater
    "b2o$o2bo$b2o!",         # beehive
    "bo$obo$bo!",            # tub
    "2o$obo$bo!",            # boat
    "b2o$o2bo$bobo$2bo!",    # loaf
    "b2o$o2bo$o2bo$b2o!",    # pond
)


class Step:
    """Compile and run a phase's main jitted step, keeping the compile
    time, run time and XLA's memory analysis apart."""

    def __init__(self):
        self.compile_s = 0.0
        self.run_s = 0.0
        self.memory = None

    def __call__(self, fn, *args):
        import jax

        jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
        t0 = time.perf_counter()
        compiled = jitted.lower(*args).compile()
        self.compile_s += time.perf_counter() - t0
        if self.memory is None:
            self.memory = _memory_dict(compiled.memory_analysis())
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        self.run_s += time.perf_counter() - t0
        return out


def _memory_dict(mem):
    if mem is None:
        return None
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(mem, k)) for k in keys if hasattr(mem, k)}


def _require(ok, what):
    """A failed check (raised even under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    _require(a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}")
    bad = int(np.count_nonzero(a != b))
    _require(bad == 0, f"{what}: {bad} of {a.size} entries differ")


# -- 1. rollout ---------------------------------------------------------------


def phase_rollout(step, n_boards=8192, steps=512, seed=0):
    import jax

    from lifeapi_tpu.core import step as S
    from lifeapi_tpu.native import build as nb

    rng = np.random.default_rng(seed)
    start = rng.integers(0, 2**32, size=(n_boards, 64, 2), dtype=np.uint32)
    boards = jax.device_put(start)
    out = np.asarray(step(lambda b: S.rollout(b, steps), boards))
    oracle = nb.step_packed64(nb.packed32_to_packed64(start), steps)
    _equal(nb.packed32_to_packed64(out), oracle, "rollout vs C oracle")
    scan = jax.jit(lambda b: S.step_n(b, steps))(boards)
    _equal(out, scan, "rollout vs step_n")
    return {"boards": n_boards, "steps": steps,
            "steps_per_s_incl_dispatch": n_boards * steps / step.run_s}


# -- 2. catalyst search -------------------------------------------------------


def phase_catalyst(step, horizon=64, max_offsets=None):
    import jax

    from lifeapi_tpu import search as SR
    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.symmetry import transforms as tr
    from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T

    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)
    offsets = SR.candidate_offsets(glider, eater)[:max_offsets]
    res = step(lambda a, off: SR.catalyst_search(a, eater, off, horizon),
               glider, offsets)
    ref = jax.jit(lambda a, off: SR.catalyst_search(
        a, eater, off, horizon, engine="xla"))(glider, offsets)
    for f in ("interacted", "recovered", "reaction_changed", "final"):
        _equal(getattr(res, f), getattr(ref, f), f"catalyst {f}")
    hits = int(np.asarray(SR.successful_catalysts(res)).sum())
    _require(hits > 0 or max_offsets is not None, "no eater placement works")
    return {"placements": int(offsets.shape[0]), "horizon": horizon,
            "hits": hits}


# -- 3. MPC -------------------------------------------------------------------


def _mpc_problem(horizon):
    import jax.numpy as jnp

    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.mpc import CostWeights, MPCProblem
    from lifeapi_tpu.target import LifeTarget

    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 31, 31))
    mask = jnp.zeros((64, 64), bool).at[20:44, 20:44].set(True)
    return MPCProblem(initial=board.empty(), target=target, horizon=horizon,
                      control_mask=mask, weights=CostWeights())


def _np_hard_costs(initial, toggles, wanted, unwanted, w):
    """Costs of packed toggles [C, T, 64, 2] re-simulated by the C oracle:
    target Hamming cost plus control effort (mpc.cost.hard_total with no
    protected region)."""
    from lifeapi_tpu.native import build as nb

    tog = nb.packed32_to_packed64(toggles)  # [C, T, 64]
    boards = np.broadcast_to(nb.packed32_to_packed64(initial),
                             tog[:, 0].shape).copy()
    for t in range(tog.shape[1]):
        boards = nb.step_packed64(boards ^ tog[:, t], 1)

    def pop(x):
        return np.array([sum(bin(int(v)).count("1") for v in row)
                         for row in x.reshape(len(x), -1)])

    wanted = nb.packed32_to_packed64(wanted)
    unwanted = nb.packed32_to_packed64(unwanted)
    hamming = pop(wanted & ~boards) + pop(unwanted & boards)
    effort = pop(tog.reshape(len(tog), -1))
    return (np.float32(w.target) * hamming.astype(np.float32)
            + np.float32(w.control) * effort.astype(np.float32)), boards


def phase_mpc(step, horizon=32, n_candidates=64, iters=100):
    import jax

    from lifeapi_tpu.mpc import solver, soft
    from lifeapi_tpu.native import build as nb

    problem = _mpc_problem(horizon)
    logits0 = solver.init_logits(jax.random.key(0), problem, n_candidates)
    logits, _ = step(
        lambda lg: solver.solve_gradient(lg, problem, iters=iters), logits0)
    probs = jax.nn.sigmoid(logits) * problem.control_mask
    costs, finals = jax.jit(
        lambda p: solver.hard_score_batch(p, problem))(probs)
    costs_x, finals_x = jax.jit(
        lambda p: solver.hard_score_batch(p, problem, use_fused=False))(probs)
    _equal(costs, costs_x, "hard costs, platform engine vs XLA")
    _equal(finals, finals_x, "hard finals, platform engine vs XLA")

    toggles = np.asarray(soft.binarize_controls(probs))
    ref_costs, ref_finals = _np_hard_costs(
        np.asarray(problem.initial), toggles,
        np.asarray(problem.target.wanted), np.asarray(problem.target.unwanted),
        problem.weights)
    _equal(nb.packed32_to_packed64(np.asarray(finals)), ref_finals,
           "hard finals vs C oracle")
    # the costs are integers times float32 weights; XLA may contract the
    # weighted sum into one fused multiply-add, so allow one rounding
    np.testing.assert_allclose(np.asarray(costs), ref_costs, rtol=2e-7,
                               err_msg="hard costs vs C oracle")

    # soft costs against the same computation on the CPU.  The relaxed
    # dynamics amplify rounding over the horizon, the more the sharper
    # the optimized controls are (a 1e-7 relative change of solved
    # logits moves their soft cost by up to ~0.6%, PERF.md), so the
    # rtol-1e-4 comparison is made at the initial logits and the
    # deviation at the solved ones is reported
    soft_fn = jax.jit(jax.vmap(lambda lg: solver.soft_objective(lg, problem)))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        problem_cpu = _mpc_problem(horizon)
        soft_cpu_fn = jax.jit(jax.vmap(
            lambda lg: solver.soft_objective(lg, problem_cpu)))
        soft_cpu0, soft_cpu = (
            np.asarray(soft_cpu_fn(jax.device_put(np.asarray(x), cpu)))
            for x in (logits0, logits))
    np.testing.assert_allclose(np.asarray(soft_fn(logits0)), soft_cpu0,
                               rtol=1e-4, err_msg="soft costs vs the CPU")
    soft_dev = np.asarray(soft_fn(logits))
    return {"candidates": n_candidates, "horizon": horizon, "iters": iters,
            "best_hard_cost": float(np.min(costs)),
            "soft_solved_max_rel_dev_vs_cpu": float(
                np.max(np.abs(soft_dev - soft_cpu) / np.abs(soft_cpu))),
            "solves_per_s_incl_dispatch": n_candidates / step.run_s}


# -- 4. bulk still-life completion -------------------------------------------


def _stable_problems(n, seed):
    """``n`` completion problems: a random still life from STILL_LIFES with
    random hidden cells and a ring of unknowns, at a random translation.
    One problem in eight also gets a lone known-ON cell far from any
    unknown, which no still life can hold."""
    import jax
    import jax.numpy as jnp

    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.stable import bitplane as BP

    pats = jnp.stack([board.move(rle.parse(s), 30, 30) for s in STILL_LIFES])
    k_pat, k_hide, k_dx, k_dy = jax.random.split(jax.random.key(seed), 4)

    @jax.jit
    def make(k_pat, k_hide, k_dx, k_dy):
        truth = pats[jax.random.randint(k_pat, (n,), 0, len(STILL_LIFES))]
        hide = truth & board.random(k_hide, (n,), p=0.3)
        lone = jnp.where((jnp.arange(n) % 8 == 7)[:, None, None],
                         board.from_cells([(50, 50)]), jnp.uint32(0))
        state = (truth & ~hide) | lone
        unknown = (board.zoi(truth) & ~truth) | hide
        dx = jax.random.randint(k_dx, (n,), 0, 64)
        dy = jax.random.randint(k_dy, (n,), 0, 64)
        return board.move_dyn(state, dx, dy), board.move_dyn(unknown, dx, dy)

    state, unknown = make(k_pat, k_hide, k_dx, k_dy)
    return BP.make(state=state, unknown=unknown)


def _dfs_minimum(state, unknown):
    """Exact minimum completion (dense board) by the host DFS recursion
    over the whole unknown area, or None when there is none."""
    from lifeapi_tpu.stable import complete as C
    from lifeapi_tpu.stable.host import HostStable

    search = C._Search(time.monotonic() + 60.0, True, False,
                       np.zeros((64, 64), bool))
    search.step(HostStable(state=state, unknown=unknown))
    _require(time.monotonic() < search.deadline, "host DFS timed out")
    return search.best


def phase_stable(step, chunk=8192, n_chunks=16, frontier=4, iters=24,
                 check_chunks=(0, 7), dfs_samples=64, seed=0):
    from lifeapi_tpu.native import build as nb
    from lifeapi_tpu.stable import bitplane as BP
    from lifeapi_tpu.stable import complete as C
    from lifeapi_tpu.stable.host import HostStable

    n = chunk * n_chunks
    bst = _stable_problems(n, seed)
    t0 = time.perf_counter()
    res = C.complete_stable_beam_queued(bst, chunk=chunk, frontier=frontier,
                                        iters=iters)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = C.complete_stable_beam_queued(bst, chunk=chunk, frontier=frontier,
                                        iters=iters)
    step.run_s += time.perf_counter() - t0
    step.compile_s += max(first - step.run_s, 0.0)
    planes = (bst.state, bst.unknown) + tuple(bst.ruled)
    step.memory = _memory_dict(C._QUEUED_JIT.lower(
        planes, chunk=chunk, frontier=frontier, iters=iters,
        minimise=True).compile().memory_analysis())

    state = np.asarray(bst.state)
    unknown = np.asarray(bst.unknown)
    for c in check_chunks:
        sl = slice(c * chunk, (c + 1) * chunk)
        ref = C.complete_stable_beam(
            BP.BitStable(bst.state[sl], bst.unknown[sl],
                         tuple(r[sl] for r in bst.ruled)),
            frontier=frontier, iters=iters, dense=False)
        _equal(res.found[sl], ref.found, f"chunk {c} found")
        _equal(res.best_pop[sl], ref.best_pop, f"chunk {c} best_pop")
        _equal(res.proved_inconsistent[sl], ref.proved_inconsistent,
               f"chunk {c} proved")
        f = ref.found
        best = nb.packed32_to_packed64(ref.best[f])
        _equal(nb.step_packed64(best, 1), best, f"chunk {c} still lifes")
        known = nb.packed32_to_packed64(state[sl][f])
        allowed = known | nb.packed32_to_packed64(unknown[sl][f])
        _equal(best & known, known, f"chunk {c} boards keep the knowns")
        _equal(best & ~allowed, np.zeros_like(best),
               f"chunk {c} boards stay inside state|unknown")

    rng = np.random.default_rng(seed)
    # half the sample from the problems with a lone cell
    unsat = np.arange(7, n, 8)
    k = min(dfs_samples // 2, len(unsat))
    sample = np.concatenate([
        rng.choice(unsat, size=k, replace=False),
        rng.choice(np.setdiff1d(np.arange(n), unsat),
                   size=min(dfs_samples - k, n - len(unsat)), replace=False)])
    for i in sample:
        st = C._np_to_dense(state[i])
        un = C._np_to_dense(unknown[i])
        verdict, _ = C.complete_stable(HostStable(state=st, unknown=un),
                                       timeout=60.0, strict=True)
        best = _dfs_minimum(st, un)
        if res.found[i]:
            _require(verdict == C.CompletionResult.COMPLETED,
                     f"problem {i}: DFS finds no completion")
            _require(best is not None and res.best_pop[i] >= best.sum(),
                     f"problem {i}: beam pop {res.best_pop[i]} below the "
                     f"DFS minimum")
        if res.proved_inconsistent[i]:
            _require(verdict == C.CompletionResult.INCONSISTENT
                     and best is None,
                     f"problem {i}: proved inconsistent, DFS completes it")
    return {"problems": n, "chunk": chunk, "frontier": frontier,
            "iters": iters, "found": int(res.found.sum()),
            "proved_inconsistent": int(res.proved_inconsistent.sum()),
            "dfs_checked": len(sample),
            "problems_per_s_incl_dispatch": n / step.run_s}


# -- 5. convolution -----------------------------------------------------------


def _np_counts_fft(da, db):
    """Circular convolution counts by numpy's float64 FFT (exact after
    rounding: counts <= 4096)."""
    fa = np.fft.fft2(da.astype(np.float64))
    fb = np.fft.fft2(db.astype(np.float64))
    return np.rint(np.fft.ifft2(fa * fb).real).astype(np.int64)


def _np_counts_brute(da, db):
    """Counts by summing one shifted copy of ``db`` per ON cell of ``da``."""
    out = np.zeros((64, 64), np.int64)
    for x, y in zip(*np.nonzero(da)):
        out += np.roll(np.roll(db, x, axis=0), y, axis=1)
    return out


def _np_interaction(da, db):
    """numpy counterpart of core.convolve.interaction_offsets."""
    def counts(g):
        return sum(np.roll(np.roll(g, i, 0), j, 1)
                   for i in (-1, 0, 1) for j in (-1, 0, 1)).astype(int)

    def masks(s):
        c = counts(s)
        return c == 1, c == 2, c == 3, c >= 1, c >= 2, c >= 4

    b = np.roll(np.roll(db[::-1, ::-1], 1, 0), 1, 1)  # board.mirrored
    a1, a2, a3, ag1, ag2, ag4 = masks(da)
    b1, b2, b3, bg1, bg2, bg4 = masks(b)
    pairs = [(da, b), (a1 & ~da, b2 & ~b), (b1 & ~b, a2 & ~da),
             (a3 & da, bg2 & ~b), (ag4 & da, bg1 & ~b),
             (b3 & b, ag2 & ~da), (bg4 & b, ag1 & ~da)]
    return np.any([_np_counts_fft(l, r) > 0 for l, r in pairs], axis=0)


def phase_conv(step, n_pairs=4096, brute_pairs=32, seed=0):
    import jax.numpy as jnp

    from lifeapi_tpu.core import board
    from lifeapi_tpu.core import convolve as CV

    rng = np.random.default_rng(seed)
    sparse = np.zeros((n_pairs, 64, 64), bool)
    for i in range(n_pairs):
        k = int(rng.integers(1, 49))
        sparse[i, rng.integers(0, 64, k), rng.integers(0, 64, k)] = True
    dense_a = rng.random((n_pairs, 64, 64)) < 0.3
    dense_b = rng.random((n_pairs, 64, 64)) < 0.3
    out = {}
    for name, da, db in (("sparse", dense_a, sparse),
                         ("dense", dense_a, dense_b)):
        a = board.from_dense(jnp.asarray(da))
        b = board.from_dense(jnp.asarray(db))
        if name == "dense":
            counts = step(CV.convolve_counts, a, b)
        else:  # concrete sparse operand: the population-bounded peel loop
            counts = CV.convolve_counts(a, b)
        counts = np.asarray(counts)
        _equal(counts, np.stack([_np_counts_fft(x, y)
                                 for x, y in zip(da, db)]),
               f"{name} counts vs numpy FFT")
        for i in range(min(brute_pairs, n_pairs)):
            _equal(counts[i], _np_counts_brute(da[i], db[i]),
                   f"{name} counts vs brute force, pair {i}")
        _equal(board.to_dense(CV.convolve(a, b)), counts > 0,
               f"{name} convolve vs counts")
        k = min(brute_pairs, n_pairs)
        inter = np.asarray(board.to_dense(
            CV.interaction_offsets(a[:k], b[:k])))
        _equal(inter, np.stack([_np_interaction(x, y)
                                for x, y in zip(da[:k], db[:k])]),
               f"{name} interaction_offsets vs numpy")
        out[f"{name}_max_count"] = int(counts.max())
    out["pairs"] = n_pairs
    return out


# -- 6. the gpu-marked tests --------------------------------------------------


def phase_gpu_tests(step):
    import os

    import pytest

    os.environ["LIFEAPI_TEST_PLATFORM"] = "gpu"
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", str(REPO / "tests")])
    step.run_s += time.perf_counter() - t0
    _require(rc == 0, f"gpu-marked tests failed (pytest exit code {rc})")
    return {"pytest_exit_code": int(rc)}


# -- four cards ---------------------------------------------------------------


def phase_four(step, n_boards=4 * 8192, steps=512, horizon=64,
               n_problems=4 * 8192, beam_iters=24, replicas=1024,
               portfolio_iters=48, candidates=64, mpc_horizon=32,
               mpc_iters=100):
    """The sharded paths of parallel.elite on a (2 x 2) mesh of four
    devices at four times the single-card widths, each against the same
    call on a one-device mesh."""
    import jax
    import jax.numpy as jnp

    from lifeapi_tpu import search as SR
    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.core.step import step as life_step
    from lifeapi_tpu.parallel import elite, make_mesh
    from lifeapi_tpu.symmetry import transforms as tr
    from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T

    devices = jax.devices()
    _require(len(devices) >= 4, f"--four needs 4 GPUs, found {len(devices)}")
    mesh4 = make_mesh(n_scenario=2, n_candidate=2, devices=devices[:4])
    mesh1 = make_mesh(n_scenario=1, n_candidate=1, devices=devices[:1])
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r4 = jax.block_until_ready(fn(mesh4))
        t4 = time.perf_counter() - t0
        r1 = jax.block_until_ready(fn(mesh1))
        out[name] = {"mesh4_first_call_s": t4}
        return r4, r1

    # rollout: 4 x 8,192 boards, 512 generations
    boards = board.random(jax.random.key(0), (n_boards,))
    (f4, p4), (f1, p1) = timed(
        "rollout", lambda m: elite.sharded_rollout(boards, steps, m))
    _equal(f4, f1, "sharded_rollout boards")
    _equal(p4, p1, "sharded_rollout population")

    # catalyst: every candidate offset, repeated to 4x and a multiple of 4
    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)
    offs = jnp.tile(SR.candidate_offsets(glider, eater), (4, 1))
    offs = offs[:offs.shape[0] // 4 * 4]
    r4, r1 = timed("catalyst", lambda m: elite.sharded_catalyst_search(
        glider, eater, offs, horizon, m))
    for x, y, what in zip(r4, r1, ("interacted", "recovered", "hits")):
        _equal(x, y, f"sharded_catalyst_search {what}")

    # beam: 4 x 8,192 varied problems, frontier 4, 24 iterations
    bst = _stable_problems(n_problems, seed=1)
    for two_phase in (False, True):
        r4, r1 = timed(f"beam_two_phase_{two_phase}",
                       lambda m: elite.sharded_beam_complete(
                           bst, m, frontier=4, iters=beam_iters,
                           two_phase=two_phase))
        for x, y, what in zip(r4[:3], r1[:3], ("found", "best", "pop")):
            _equal(x, y, f"sharded_beam_complete {what}")
        _equal(r4[4], r1[4], "sharded_beam_complete champion pop")
        champ = r4[3]
        _require(bool(board.equal(life_step(champ), champ)),
                 "sharded beam champion is not a still life")

    # portfolio: one hard instance, 4 x 256 replicas
    eat = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)])
    unknown = (board.zoi(eat) & ~eat) | hide
    pf4, pf1 = timed("portfolio", lambda m: elite.sharded_portfolio(
        eat & ~hide, unknown, jax.random.key(3), m, replicas=replicas,
        frontier=4, iters=portfolio_iters, two_phase=True))
    _require(pf4.found and pf4.best_pop == pf1.best_pop,
             f"portfolio champion pop {pf4.best_pop} != {pf1.best_pop}")
    _require(pf4.found_fraction == pf1.found_fraction,
             "portfolio found fraction")
    b = jnp.asarray(pf4.best)
    _require(bool(board.equal(life_step(b), b)),
             "portfolio champion is not a still life")

    # scenario sweep: 4 scenarios x 64 candidates, horizon 32, 100 iters
    problem = _mpc_problem(mpc_horizon)
    initials = board.random(jax.random.key(5), (4,), p=0.05)
    (per4, ch4), (per1, ch1) = timed(
        "scenario_sweep", lambda m: elite.sharded_scenario_sweep(
            initials, problem.target, mpc_horizon, problem.control_mask, m,
            jax.random.key(0), candidates_per_scenario=candidates,
            iters=mpc_iters))
    np.testing.assert_allclose(np.asarray(per4), np.asarray(per1),
                               rtol=1e-4, err_msg="scenario sweep")
    np.testing.assert_allclose(float(ch4), float(ch1), rtol=1e-4)
    step.run_s = sum(v["mesh4_first_call_s"] for v in out.values())
    return out


# -- driver -------------------------------------------------------------------


def _card():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def _run_phase(i, name, fn):
    import jax

    step = Step()
    t0 = time.perf_counter()
    detail = fn(step)
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    print(f"phase {i} {name}: ok wall={wall:.3f}s "
          f"compile={step.compile_s:.3f}s run={step.run_s:.6f}s "
          f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
          f"memory_analysis={json.dumps(step.memory)} "
          f"detail={json.dumps(detail)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lifeapi_tpu.utils import compile_cache

    print(f"phase 0 device: {dev.device_kind}, jax {jax.__version__}, "
          f"{len(jax.devices())} device(s), compile cache "
          f"{compile_cache.enable()}", flush=True)
    print(_card(), flush=True)

    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [("rollout", phase_rollout), ("catalyst", phase_catalyst),
                  ("mpc", phase_mpc), ("stable", phase_stable),
                  ("conv", phase_conv), ("gpu_tests", phase_gpu_tests)]
    for i, (name, fn) in enumerate(phases, start=1):
        _run_phase(i, name, fn)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
