import numpy as np
import jax
import jax.numpy as jnp

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.stable import propagate as P
from lifeapi_tpu.utils import checkpoint, debug, prng, profiling


def test_key_sequence_deterministic():
    ks1 = prng.KeySequence(42)
    ks2 = prng.KeySequence(42)
    a = jax.random.uniform(ks1())
    b = jax.random.uniform(ks2())
    assert float(a) == float(b)
    # subsequent keys differ
    assert float(jax.random.uniform(ks1())) != float(a)


def test_benchmark_runs():
    f = jax.jit(lambda x: x * 2)
    dt = profiling.benchmark(f, jnp.ones((8, 8)), reps=3, warmup=1)
    assert dt > 0


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "boards": board.from_cells([(1, 2), (3, 4)]),
        "logits": jnp.arange(12.0).reshape(3, 4),
    }
    path = tmp_path / "ckpt"
    checkpoint.save(path, state)
    back = checkpoint.restore(path, template=state)
    assert (np.asarray(back["boards"]) == np.asarray(state["boards"])).all()
    assert (np.asarray(back["logits"]) == np.asarray(state["logits"])).all()


def test_checkpoint_rle(tmp_path):
    b = board.from_cells([(40, 40), (41, 41)])
    p = tmp_path / "b.rle"
    checkpoint.save_rle(p, b)
    back = checkpoint.load_rle(p)
    assert bool(board.equal(back, board.move(b, -32, -32)))


def test_stable_invariants():
    st = P.make(state=board.to_dense(board.from_cells([(5, 5)])),
                unknown=jnp.zeros((64, 64), bool))
    st = P.synchronise_state_known(st).stable
    debug.assert_stable_invariants(st)
    debug.check_board_packed(board.empty())


def test_lane_ops_cse_dedups_and_dces():
    """Value-numbering CSE must count duplicate (incl. commuted)
    subexpressions once and drop dead code; identical-op counts match
    lane_ops on redundancy-free functions."""
    import jax.numpy as jnp

    from lifeapi_tpu.utils import roofline as R

    e = jnp.zeros((64, 8), jnp.uint32)

    def dup(x, y):
        a = x & y
        b = y & x          # commuted duplicate
        dead = x ^ y       # dead code
        del dead
        return a | b

    assert R.lane_ops(dup, e, e) == 4 * 64 * 8  # dead op counted pre-CSE
    assert R.lane_ops_cse(dup, e, e) == 2 * 64 * 8  # one AND + one OR

    def clean(x, y):
        return (x & y) | (x ^ y)

    assert R.lane_ops(clean, e, e) == R.lane_ops_cse(clean, e, e)


def test_step_kernel_has_no_cse_redundancy():
    """The CSA step's pre- and post-CSE counts agree (its roofline
    numerator needs no CSE correction); the propagate step's do not."""
    from lifeapi_tpu.utils import roofline as R

    assert (R.step_lane_ops_per_board()
            == R.step_lane_ops_per_board(post_cse=True) == 3328)
    pre = R.fixpoint_step_lane_ops_per_board()
    post = R.fixpoint_step_lane_ops_per_board(post_cse=True)
    assert post < pre  # the shared-threshold circuits carry redundancy
