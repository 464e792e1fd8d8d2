"""The packed bit-plane solver must agree exactly with the dense solver
(which itself is exhaustively verified against the scalar spec)."""

import numpy as np
import jax.numpy as jnp

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.stable import bitplane as BP
from lifeapi_tpu.stable import propagate as P
from oracle import random_dense

N = 64


def _random_stable(rng, batch=4, p_state=0.15, p_unknown=0.25, p_ruled=0.1):
    state = random_dense(rng, p=p_state, batch=(batch,))
    unknown = random_dense(rng, p=p_unknown, batch=(batch,)) & ~state
    ruled = (rng.random((batch, N, N, 8)) < p_ruled)
    ruled_mask = np.zeros((batch, N, N), np.uint8)
    for i in range(8):
        ruled_mask |= ruled[..., i].astype(np.uint8) << i
    return P.Stable(jnp.asarray(state), jnp.asarray(unknown),
                    jnp.asarray(ruled_mask))


def _assert_same(dense_st, bit_st):
    back = BP.to_dense_stable(bit_st)
    assert (np.asarray(back.state) == np.asarray(dense_st.state)).all()
    assert (np.asarray(back.unknown) == np.asarray(dense_st.unknown)).all()
    assert (np.asarray(back.ruled) == np.asarray(dense_st.ruled)).all()


def test_conversion_roundtrip(rng):
    st = _random_stable(rng)
    _assert_same(st, BP.from_dense_stable(st))


def test_sync_matches_dense(rng):
    for _ in range(3):
        st = _random_stable(rng)
        d = P.synchronise_state_known(st)
        b = BP.synchronise_state_known(BP.from_dense_stable(st))
        assert (np.asarray(b.consistent) == np.asarray(d.consistent)).all()
        ok = np.asarray(d.consistent)
        if ok.all():
            _assert_same(d.stable, b.stable)
        assert (np.asarray(b.changed) == np.asarray(d.changed)).all()


def test_update_matches_dense(rng):
    for _ in range(3):
        st = _random_stable(rng)
        # update assumes counts/state are in sync: sync first, keep
        # consistent boards
        st = P.synchronise_state_known(st).stable
        d = P.update_options(st)
        b = BP.update_options(BP.from_dense_stable(st))
        assert (np.asarray(b.consistent) == np.asarray(d.consistent)).all()
        if np.asarray(d.consistent).all():
            _assert_same(d.stable, b.stable)


def test_signal_matches_dense(rng):
    for _ in range(5):
        st = _random_stable(rng, p_ruled=0.15)
        st = P.synchronise_state_known(st).stable
        st = P.update_options(st).stable
        d = P.signal_neighbours(st)
        b = BP.signal_neighbours(BP.from_dense_stable(st))
        assert (np.asarray(b.consistent) == np.asarray(d.consistent)).all()
        both_ok = np.asarray(d.consistent) & np.asarray(b.consistent)
        if both_ok.all():
            _assert_same(d.stable, b.stable)


def test_propagate_matches_dense_on_real_problems(rng):
    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)])
    unknown = (board.zoi(eater) & ~eater) | hide

    st = P.make(state=board.to_dense(eater & ~hide),
                unknown=board.to_dense(unknown))
    d = P.propagate(st)
    b = BP.propagate(BP.from_dense_stable(st))
    assert bool(d.consistent) and bool(b.consistent)
    _assert_same(d.stable, b.stable)


def test_propagate_matches_dense_random_batch(rng):
    from lifeapi_tpu.stable import host as H

    batch = 6
    states, unknowns = [], []
    for i in range(batch):
        truth = np.zeros((N, N), bool)
        # random still-life-ish seed: scattered blocks
        for _ in range(6):
            x, y = rng.integers(4, 56, 2)
            truth[x:x + 2, y:y + 2] = True
        hide = (rng.random((N, N)) < 0.3) & H.zoi(truth)
        states.append(truth & ~hide)
        unknowns.append(hide | (H.zoi(H.zoi(truth)) & ~truth))
    st = P.make(state=jnp.asarray(np.stack(states)),
                unknown=jnp.asarray(np.stack(unknowns)))
    d = P.propagate(st)
    b = BP.propagate(BP.from_dense_stable(st))
    assert (np.asarray(b.consistent) == np.asarray(d.consistent)).all()
    ok = np.asarray(d.consistent)
    back = BP.to_dense_stable(b.stable)
    for i in range(batch):
        if ok[i]:
            assert (np.asarray(back.state[i]) == np.asarray(d.stable.state[i])).all()
            assert (np.asarray(back.unknown[i]) == np.asarray(d.stable.unknown[i])).all()
            assert (np.asarray(back.ruled[i]) == np.asarray(d.stable.ruled[i])).all()


def test_simple_step_matches_dense(rng):
    """Packed cheap rule (bitplane.propagate_simple_step / simple_circuit)
    vs the dense propagate.propagate_simple_step (round-2 VERDICT #3)."""
    for trial in range(6):
        st = _random_stable(rng, p_state=0.1 + 0.05 * (trial % 3),
                            p_unknown=0.2, p_ruled=0.0)
        d = P.propagate_simple_step(P.Stable(st.state, st.unknown, st.ruled))
        b = BP.propagate_simple_step(BP.from_dense_stable(st))
        assert (np.asarray(b.consistent) == np.asarray(d.consistent)).all()
        assert (np.asarray(b.changed) == np.asarray(d.changed)).all()
        ok = np.asarray(d.consistent)
        back = BP.to_dense_stable(b.stable)
        for i in range(len(ok)):
            if ok[i]:
                assert (np.asarray(back.state[i])
                        == np.asarray(d.stable.state[i])).all()
                assert (np.asarray(back.unknown[i])
                        == np.asarray(d.stable.unknown[i])).all()


def test_ternary_packed_matches_dense(rng):
    from lifeapi_tpu.stable import ternary

    for naive in (False, True):
        d = random_dense(rng, p=0.35)
        unk = random_dense(rng, p=0.1) & ~d
        s_dense, u_dense = ternary.step_ternary(
            jnp.asarray(d), jnp.asarray(unk), naive=naive
        )
        sp, up = BP.step_ternary_packed(
            board.from_dense(jnp.asarray(d)), board.from_dense(jnp.asarray(unk)),
            naive=naive,
        )
        assert (np.asarray(board.to_dense(sp)) == np.asarray(s_dense)).all()
        assert (np.asarray(board.to_dense(up)) == np.asarray(u_dense)).all()


def test_vulnerable_matches_dense(rng):
    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    unknown = board.zoi(eater) & ~eater
    st = P.make(state=board.to_dense(eater), unknown=board.to_dense(unknown))
    st = P.propagate(st).stable
    d = P.vulnerable(st)
    bst = BP.from_dense_stable(st)
    b = BP.vulnerable(bst)
    assert (np.asarray(board.to_dense(b)) == np.asarray(d)).all()


def test_gt_thresholds7_exhaustive():
    """The shared thermometer decode must equal gt_const for every nibble
    value 0..15 and threshold 0..6."""
    from lifeapi_tpu.stable import nibble as nb

    vals = np.arange(16, dtype=np.int32)
    grid = np.broadcast_to(vals[:, None, None], (16, N, N))
    x = nb.encode(jnp.asarray(grid))
    got = BP._gt_thresholds7(x)
    for c in range(7):
        exp = np.asarray(board.to_dense(nb.gt_const(x, c)))
        assert (np.asarray(board.to_dense(got[c])) == exp).all(), c


def test_signal_post_exhaustive_vs_signal_circuit():
    """Exhaustive (center three-state x A x U x ruled-mask) equivalence of
    signal_circuit_post (the post-update specialisation) vs the untouched
    signal_circuit, on post-update ruled planes.  Random boards with
    all-zero initial ruled planes cannot reach the constrained-options
    corners (e.g. a dead6-only cell with AU > 6, which a dropped c=6 term
    in has_below turns into an unsound signal_on); this enumeration can."""
    cases = []
    for st_b, un_b in ((1, 0), (0, 1), (0, 0)):
        for a in range(9):
            for u in range(9 - a):
                for m in range(256):
                    cases.append((st_b, un_b, a, u, m))
    arr = np.array(cases, np.uint32)
    n = len(arr)
    nwords = -(-n // 32)
    arr = np.concatenate([arr, np.repeat(arr[-1:], nwords * 32 - n, axis=0)])

    def pack(bits):
        return jnp.asarray(
            (bits.astype(np.uint32).reshape(nwords, 32)
             << np.arange(32, dtype=np.uint32)).sum(axis=1, dtype=np.uint32))

    st_b, un_b, a_v, u_v, m_v = arr.T
    state, unknown = pack(st_b), pack(un_b)
    ruled = tuple(pack((m_v >> i) & 1) for i in range(8))

    def nib(v):
        return tuple(pack((v >> j) & 1) for j in range(4))

    A, U, AU = nib(a_v), nib(u_v), nib(a_v + u_v)
    s9 = nib(a_v + st_b)
    m9 = nib(a_v + u_v + st_b + un_b)

    rl2, ab_u, _ = BP.update_circuit_interval(state, unknown, ruled, A, AU)
    post = BP.signal_circuit_post(state, unknown, rl2, A, U, AU)
    ref = BP.signal_circuit(state, unknown, rl2, s9, m9)
    ok = ~np.asarray(ab_u)
    names = ("signal_on", "signal_off", "center_on_f", "center_off_f")
    for name, p, r in zip(names, post, ref):
        bad = (np.asarray(p) ^ np.asarray(r)) & ok
        assert not bad.any(), name
