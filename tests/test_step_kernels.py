"""The fused CUDA rollouts (ops/step_cuda) against the plain XLA path.

The even/odd step, the kernels' packing and the engine dispatch run on
the CPU; the kernels themselves have no CPU form, so their comparisons
with core.step are marked ``gpu``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lifeapi_tpu.core import bitops, board, step
from lifeapi_tpu.ops import step_cuda
from oracle import random_dense


def test_interleave_roundtrip(rng):
    vals = rng.integers(0, 2**64, size=64, dtype=np.uint64)
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    e, o = bitops.interleave_split(lo, hi)
    # bit k of e is bit 2k of the 64-bit value
    for i in [0, 5, 63]:
        v = int(vals[i])
        ev = int(e[i])
        ov = int(o[i])
        for k in range(32):
            assert (ev >> k) & 1 == (v >> (2 * k)) & 1
            assert (ov >> k) & 1 == (v >> (2 * k + 1)) & 1
    rlo, rhi = bitops.interleave_merge(e, o)
    assert (np.asarray(rlo) == np.asarray(lo)).all()
    assert (np.asarray(rhi) == np.asarray(hi)).all()


@pytest.mark.parametrize("batch", [(1,), (16,), (3, 5)])
def test_eo_layout_roundtrip(rng, batch):
    p = board.from_dense(jnp.asarray(random_dense(rng, batch=batch)))
    eo = step_cuda.to_eo(p)
    assert eo.shape == p.shape and eo.dtype == jnp.uint32
    assert (np.asarray(step_cuda.from_eo(eo)) == np.asarray(p)).all()


@pytest.mark.parametrize("density", [0.05, 0.4, 0.8])
def test_step_eo_matches_core(rng, density):
    d = random_dense(rng, p=density, batch=(16,))
    p = board.from_dense(jnp.asarray(d))
    eo = step_cuda.to_eo(p)
    ne, no = step.step_eo(eo[..., 0], eo[..., 1])
    got = step_cuda.from_eo(jnp.stack([ne, no], axis=-1))
    assert bool(board.equal(got, step.step(p)).all())


def test_rollout_default_engine_is_xla_on_cpu(rng):
    d = random_dense(rng, p=0.35, batch=(128,))
    p = board.from_dense(jnp.asarray(d))
    got = step.rollout(p, 8)
    assert bool(board.equal(got, step.step_n(p, 8)).all())
    got_x = step.rollout(p, 8, engine="xla")
    assert (np.asarray(got_x) == np.asarray(got)).all()


def test_rollout_cuda_engine_raises_without_gpu(rng):
    p = board.from_dense(jnp.asarray(random_dense(rng, batch=(4,))))
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        step.rollout(p, 4, engine="cuda")


def test_rollout_matches_c_oracle(rng):
    """The public rollout, whatever engine the platform picks, against
    the independent native C oracle."""
    from lifeapi_tpu.native import build as nb

    p = board.random(jax.random.key(3), (64,), p=0.4)
    got = nb.packed32_to_packed64(np.asarray(step.rollout(p, 40)))
    ref = nb.step_packed64(nb.packed32_to_packed64(np.asarray(p)), 40)
    assert (got == ref).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n_boards,steps", [(1, 1), (37, 0), (37, 7),
                                             (128, 64), (1000, 33)])
def test_cuda_rollout_matches_scan(rng, n_boards, steps):
    """The CUDA rollout kernel equals step_n, including batches that do
    not fill a thread block and a zero-step rollout."""
    p = board.from_dense(jnp.asarray(
        random_dense(rng, p=0.35, batch=(n_boards,))))
    got = step.rollout(p, steps, engine="cuda")
    assert (np.asarray(got) == np.asarray(step.step_n(p, steps))).all()


@pytest.mark.gpu
def test_rollout_leading_dims(rng):
    p = board.from_dense(jnp.asarray(random_dense(rng, batch=(3, 5))))
    got = step.rollout(p, 9, engine="cuda")
    assert got.shape == p.shape
    assert (np.asarray(got) == np.asarray(step.step_n(p, 9))).all()


@pytest.mark.gpu
def test_controlled_rollout_matches_hard_rollout(rng):
    from lifeapi_tpu.mpc import soft

    d = random_dense(rng, p=0.3, batch=(130,))
    p = board.from_dense(jnp.asarray(d))
    T = 6
    tog_dense = random_dense(rng, p=0.02, batch=(T, 130))
    toggles = board.from_dense(jnp.asarray(tog_dense))
    got = step_cuda.controlled_rollout(p, toggles)
    # reference path: scan of xor + step, per board (hard_rollout maps over
    # the [T, B, ...] toggles with boards batched)
    expect = soft.hard_rollout(p, toggles)
    assert bool(board.equal(got, expect).all())
