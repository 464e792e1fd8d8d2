"""Operation counts for roofline accounting (SURVEY.md §5.1).

The hot paths here are integer/boolean bit logic, so the roofline that
matters is 32-bit *lane-ops per second* against the device's integer-ALU
issue rate, not FLOPs.  This module counts the lane-ops of a function
body mechanically from its jaxpr, so the counts track the code.  It knows
no device: a benchmark divides a measured rate by a peak it states with
its source (:func:`pct_of_peak` takes the peak as an argument).

CPU baseline model (for the host-oracle comparisons): one Xeon core at
2.1 GHz executing ~3 scalar 64-bit ALU ops/cycle ~= 6.3e9 word-ops/s;
each 64-bit word-op is 2 lane-ops in the 32-bit accounting below.
"""

from __future__ import annotations

import jax
import numpy as np

# primitives that are pure data-plumbing in a fused kernel: either
# compiled away entirely or not representative of ALU pressure
_FREE_PRIMS = {
    "broadcast_in_dim", "reshape", "squeeze", "transpose", "copy",
    "convert_element_type", "stop_gradient", "slice",
}


def _count_jaxpr(jaxpr):
    """Total output elements across counted eqns (recursing into control
    flow is deliberately NOT done: trace loop *bodies*)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in _FREE_PRIMS:
            continue
        if name in ("pjit", "closed_call", "custom_jvp_call",
                    "custom_vjp_call"):
            inner = eqn.params.get("jaxpr")
            if inner is not None:
                total += _count_jaxpr(
                    inner.jaxpr if hasattr(inner, "jaxpr") else inner
                )
            continue
        for out in eqn.outvars:
            shape = getattr(out.aval, "shape", ())
            total += int(np.prod(shape, dtype=np.int64)) if shape else 1
    return total


def lane_ops(fn, *example_args):
    """Count vector lane-ops of one evaluation of ``fn`` (a loop BODY —
    no data-dependent control flow) by tracing its jaxpr.  Every counted
    primitive contributes its output element count; data movement
    (concatenate for column rolls) counts as one op per element.

    These are PRE-compiler counts — an UPPER bound on executed ops: the
    compiler eliminates repeated subexpressions, so circuits with shared
    subexpressions execute fewer (see :func:`lane_ops_cse`)."""
    jaxpr = jax.make_jaxpr(fn)(*example_args)
    return _count_jaxpr(jaxpr.jaxpr)


def pct_of_peak(achieved_lane_ops_per_s, peak):
    """Percent of ``peak`` lane-ops/s; the caller names the device's peak
    and its source."""
    return 100.0 * achieved_lane_ops_per_s / peak


# -- post-CSE counting (round-3 VERDICT directive #6) -----------------------

_COMMUTATIVE = {"and", "or", "xor", "add", "mul", "max", "min"}


def _params_key(params):
    return tuple(sorted(
        (k, repr(v)) for k, v in params.items()
        if k not in ("jaxpr", "call_jaxpr", "branches", "cond_jaxpr",
                     "body_jaxpr")
    ))


def _cse_count_jaxpr(jaxpr):
    """Output-element count after local value-numbering CSE + dead-code
    elimination on the jaxpr: two eqns with the same primitive, params and
    (operand-order-normalized, for commutative prims) inputs count ONCE,
    and eqns whose results never reach an output count ZERO.  This is the
    dedup a compiler performs, so these counts are the honest numerator
    for ``% of peak``.  Remaining slack vs the true executed
    count: algebraic rewrites beyond CSE, and cross-``pjit``-boundary
    sharing (not attempted — sub-jaxprs are counted independently)."""
    vn = {}          # var -> value number
    next_vn = [0]

    def fresh():
        next_vn[0] += 1
        return next_vn[0] - 1

    def operand_vn(v):
        if hasattr(v, "val"):  # Literal
            key = ("lit", str(getattr(v, "aval", None)), repr(v.val))
            if key not in seen:
                seen[key] = fresh()
            return seen[key]
        return vn[v]

    seen = {}
    for v in list(jaxpr.invars) + list(jaxpr.constvars):
        vn[v] = fresh()

    _CALL_PRIMS = ("jit", "pjit", "closed_call", "custom_jvp_call",
                   "custom_vjp_call")

    kept = []          # live-analysis worklist, program order
    inner_count = {}   # id(eqn) -> nested sub-jaxpr count (call prims)
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in _CALL_PRIMS:
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            n = 0
            if inner is not None:
                n = _cse_count_jaxpr(
                    inner.jaxpr if hasattr(inner, "jaxpr") else inner
                )
            inner_count[id(eqn)] = n
            for out in eqn.outvars:
                vn[out] = fresh()
            kept.append(eqn)
            continue
        ops = [operand_vn(v) for v in eqn.invars]
        if name in _COMMUTATIVE:
            ops = sorted(ops)
        key = (name, _params_key(eqn.params), tuple(ops))
        if key in seen and not eqn.effects:
            for out, o in zip(eqn.outvars, seen[key]):
                vn[out] = o
        else:
            outs = tuple(fresh() for _ in eqn.outvars)
            seen[key] = outs
            for out, o in zip(eqn.outvars, outs):
                vn[out] = o
            kept.append(eqn)

    # dead-code elimination: walk kept eqns backwards from the outputs
    live = set()
    for v in jaxpr.outvars:
        if not hasattr(v, "val"):
            live.add(vn.get(v))
    total = 0
    for eqn in reversed(kept):
        out_vns = [vn[o] for o in eqn.outvars]
        if not any(o in live for o in out_vns) and not eqn.effects:
            continue
        for v in eqn.invars:
            if not hasattr(v, "val"):
                live.add(vn[v])
        if id(eqn) in inner_count:
            total += inner_count[id(eqn)]
            continue
        if eqn.primitive.name in _FREE_PRIMS:
            continue
        for out in eqn.outvars:
            shape = getattr(out.aval, "shape", ())
            total += int(np.prod(shape, dtype=np.int64)) if shape else 1
    return total


def lane_ops_cse(fn, *example_args):
    """Post-CSE/DCE lane-op count of one evaluation of ``fn`` — the
    executed-op estimate that replaces the pre-CSE upper bound of
    :func:`lane_ops` in ``% of peak`` columns (see _cse_count_jaxpr)."""
    jaxpr = jax.make_jaxpr(fn)(*example_args)
    return _cse_count_jaxpr(jaxpr.jaxpr)


def compiled_cost_analysis(fn, *example_args):
    """XLA's own cost model for the COMPILED artifact
    (``jit(fn).lower(...).compile().cost_analysis()``) — flops /
    transcendentals / bytes accessed.  For Pallas kernels the custom
    call of a hand-written kernel is opaque to XLA's analysis (counts
    ~0), so this is only meaningful for jnp-path pipelines; the kernels
    use :func:`lane_ops_cse` of their jnp reference instead."""
    compiled = jax.jit(fn).lower(*example_args).compile()
    try:
        return compiled.cost_analysis()
    except Exception:
        return None


def matmul_flops(fn, *example_args):
    """Total dot_general FLOPs (2*M*N*K) of one evaluation of ``fn`` —
    the matrix-unit roofline numerator for the NTT convolution."""

    def walk(jaxpr):
        total = 0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                a, b = eqn.invars[0].aval, eqn.invars[1].aval
                ((lc, rc), (lb, rb)) = eqn.params["dimension_numbers"]
                k = int(np.prod([a.shape[i] for i in lc]))
                batch = int(np.prod([a.shape[i] for i in lb])) if lb else 1
                m = int(np.prod(a.shape)) // (k * batch)
                n = int(np.prod(b.shape)) // (k * batch)
                total += 2 * batch * m * n * k
            for key in ("jaxpr",):
                inner = eqn.params.get(key)
                if inner is not None:
                    total += walk(
                        inner.jaxpr if hasattr(inner, "jaxpr") else inner
                    )
        return total

    jaxpr = jax.make_jaxpr(fn)(*example_args)
    return walk(jaxpr.jaxpr)


# -- canned counters for the flagship kernels -------------------------------


def step_lane_ops_per_board(post_cse=False):
    """Lane-ops per board per generation of the even/odd step
    (core.step.step_eo, the per-generation work of the fused CUDA
    kernels): each op processes the board's 64 uint32 column half-words
    per array.  ``post_cse`` counts after value-numbering CSE + DCE
    (identical here: the CSA step has no redundant subexpressions)."""
    import jax.numpy as jnp

    from ..core import step as S

    B = 8  # batch cancels: we count per board
    e = jnp.zeros((B, 64), jnp.uint32)
    count = lane_ops_cse if post_cse else lane_ops
    return count(S.step_eo, e, e) // B


def fixpoint_step_lane_ops_per_board(post_cse=False):
    """Lane-ops per board per full propagate step
    (stable.bitplane.propagate_step: sync + update + signal on packed
    planes).  ``post_cse`` gives the executed-op estimate (the
    shared-threshold circuits carry CSE-able redundancy at source
    level)."""
    import jax.numpy as jnp

    from ..stable import bitplane as BP

    B = 8
    z = jnp.zeros((B, 64, 2), jnp.uint32)
    count = lane_ops_cse if post_cse else lane_ops
    return count(BP.propagate_step, BP.make(state=z, unknown=z)) // B
