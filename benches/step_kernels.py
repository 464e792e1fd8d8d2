#!/usr/bin/env python
"""Hand-written CUDA rollout kernels against XLA's plain versions.

Times, on one GPU, each fused kernel of ops/step_cuda through the entry
point its users call, beside the jnp code XLA compiles for the same job,
and checks every pair bit for bit first:

* rollout: 8,192 random boards x 512 generations — ``core.step.rollout``
  on the kernel, ``core.step.step_n`` (lax.scan) and ``core.step.step_eo``
  under ``lax.fori_loop``; the C oracle checks all three;
* catalyst: glider against eater, every candidate offset, horizon 64 —
  ``search.catalyst_search`` with ``engine="cuda"`` and ``"xla"``;
* MPC hard scoring: ``mpc.solver.hard_score_batch`` at horizon 32 with
  64 candidates (BASELINE config 2) and 256 (the CEM population), fused
  and not;
* dense convolution counts on 4,096 board pairs: ``fft`` against ``ntt``.

Prints one JSON object per measurement (median and min of ``--reps``
timed calls, each fenced by ``block_until_ready``; compile time apart)
and writes them all to ``chiprun_out/step_kernels.json``.

    python benches/step_kernels.py [--reps 20]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lifeapi_tpu.utils import compile_cache  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "chiprun_out" / "step_kernels.json"


def timed(fn, *args, reps):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, {"median_s": statistics.median(ts), "min_s": min(ts),
                 "first_call_s": compile_s}


def bench_rollout(reps, records):
    from lifeapi_tpu.core import step as S
    from lifeapi_tpu.native import build as nb
    from lifeapi_tpu.ops import step_cuda

    B, T = 8192, 512
    rng = np.random.default_rng(0)
    boards = jax.device_put(
        rng.integers(0, 2**32, size=(B, 64, 2), dtype=np.uint32))
    oracle = nb.packed64_to_packed32(
        nb.step_packed64(nb.packed32_to_packed64(np.asarray(boards)), T))

    def eo_loop(b):
        eo = step_cuda.to_eo(b)
        e, o = jax.lax.fori_loop(
            0, T, lambda i, c: S.step_eo(*c), (eo[..., 0], eo[..., 1]))
        return step_cuda.from_eo(jnp.stack([e, o], axis=-1))

    variants = {"cuda": jax.jit(lambda b: S.rollout(b, T, engine="cuda")),
                "xla_step_n": jax.jit(lambda b: S.step_n(b, T))}
    variants["xla_step_eo_fori"] = jax.jit(eo_loop)
    for name, fn in variants.items():
        out, t = timed(fn, boards, reps=reps)
        exact = bool((np.asarray(out) == oracle).all())
        records.append({"bench": "rollout", "variant": name, "B": B, "T": T,
                        "bit_exact_vs_oracle": exact, **t,
                        "steps_per_s": B * T / t["median_s"]})
        print(json.dumps(records[-1]), flush=True)


def bench_catalyst(reps, records):
    from lifeapi_tpu import search as SR
    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.symmetry import transforms as tr
    from lifeapi_tpu.symmetry.transforms import SymmetryTransform as Tr

    horizon = 64
    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), Tr.Rotate270), 24, 24)
    offsets = SR.candidate_offsets(glider, eater)
    P = int(offsets.shape[0])
    ref = None
    for engine in ("cuda", "xla"):
        fn = jax.jit(lambda a, off, engine=engine: SR.catalyst_search(
            a, eater, off, horizon, engine=engine))
        res, t = timed(fn, glider, offsets, reps=reps)
        fields = [np.asarray(x) for x in res]
        if ref is None:
            ref = fields
        same = all((x == y).all() for x, y in zip(fields, ref))
        records.append({"bench": "catalyst", "variant": engine, "P": P,
                        "horizon": horizon, "same_as_cuda": same, **t,
                        "placements_per_s": P / t["median_s"]})
        print(json.dumps(records[-1]), flush=True)


def bench_mpc_hard(reps, records):
    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.mpc import CostWeights, MPCProblem, solver
    from lifeapi_tpu.target import LifeTarget

    T = 32
    target = LifeTarget.from_state(board.move(rle.parse("2o$2o!"), 31, 31))
    mask = jnp.zeros((64, 64), bool).at[20:44, 20:44].set(True)
    problem = MPCProblem(initial=board.empty(), target=target, horizon=T,
                         control_mask=mask, weights=CostWeights())
    for C in (64, 256):
        probs = jax.random.uniform(jax.random.key(1), (C, T, 64, 64)) * 0.55
        ref = None
        for fused in (True, False):
            fn = jax.jit(lambda p, fused=fused: solver.hard_score_batch(
                p, problem, use_fused=fused))
            (costs, finals), t = timed(fn, probs, reps=reps)
            cur = (np.asarray(costs), np.asarray(finals))
            if ref is None:
                ref = cur
            same = all((x == y).all() for x, y in zip(cur, ref))
            records.append({"bench": "mpc_hard_score", "variant":
                            "cuda" if fused else "xla", "C": C, "T": T,
                            "same_as_cuda": same, **t,
                            "candidates_per_s": C / t["median_s"]})
            print(json.dumps(records[-1]), flush=True)


def bench_conv(reps, records):
    from lifeapi_tpu.core import board
    from lifeapi_tpu.core import convolve as CV

    B = 4096
    rng = np.random.default_rng(0)
    a = board.from_dense(jnp.asarray(rng.random((B, 64, 64)) < 0.3))
    b = board.from_dense(jnp.asarray(rng.random((B, 64, 64)) < 0.3))
    ref = None
    for method in ("fft", "ntt", "dft"):
        fn = jax.jit(lambda x, y, m=method: CV.convolve_counts(x, y, method=m))
        out, t = timed(fn, a, b, reps=reps)
        out = np.asarray(out)
        if ref is None:
            ref = out
        records.append({"bench": "convolve_counts_dense", "variant": method,
                        "B": B, "same_as_fft": bool((out == ref).all()), **t,
                        "pairs_per_s": B / t["median_s"]})
        print(json.dumps(records[-1]), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*",
                    default=["rollout", "catalyst", "mpc", "conv"])
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("needs a GPU: these are device timings")
    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    records = [{"card": card.strip(), "device_kind": jax.devices()[0].device_kind,
                "jax": jax.__version__}]
    benches = {"rollout": bench_rollout, "catalyst": bench_catalyst,
               "mpc": bench_mpc_hard, "conv": bench_conv}
    for name in args.only:
        benches[name](args.reps, records)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
