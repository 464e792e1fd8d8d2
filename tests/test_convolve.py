import numpy as np
import jax.numpy as jnp

from lifeapi_tpu.core import board, convolve, step
from lifeapi_tpu import target as target_mod
from oracle import dilate_dense, life_step_dense, random_dense

N = 64
EATER = [(0, 0), (1, 0), (0, 1), (2, 1), (2, 2), (2, 3), (3, 3)]
GLIDER = [(1, 0), (2, 1), (0, 2), (1, 2), (2, 2)]


def test_convolve_matches_dilation(rng):
    a = random_dense(rng, p=0.1)
    kernel_cells = [(0, 0), (1, 0), (0, 1), (5, 62), (63, 63)]
    b = board.from_cells(kernel_cells)
    got = np.asarray(board.to_dense(convolve.convolve(board.from_dense(jnp.asarray(a)), b)))
    expect = dilate_dense(a, kernel_cells)
    assert (got == expect).all()


def test_convolve_sparse_path(rng):
    """The shift-OR sparse path (host-known small operand) is bit-identical
    to the dense transform path, batched, commuted, and under jit with a
    closed-over pattern; operands above the cell cap fall through."""
    import jax

    a = board.from_dense(jnp.asarray(random_dense(rng, batch=(4,), p=0.2)))
    cells = [(62, 1), (0, 5), (7, 63), (31, 32), (33, 30)]
    b = board.from_cells(cells)
    ref = convolve.convolve(a, b, method="fft")
    assert bool(jnp.all(ref == convolve.convolve_sparse(a, cells)))
    assert bool(jnp.all(ref == convolve.convolve(a, b)))
    assert bool(jnp.all(ref == convolve.convolve(b, a)))  # commuted
    jitted = jax.jit(lambda x: convolve.convolve(x, b))
    assert bool(jnp.all(ref == jitted(a)))
    # dense (population > cap) concrete operand: falls through, same result
    big = board.from_dense(jnp.asarray(random_dense(rng, p=0.5)))
    ref2 = convolve.convolve(a, big, method="fft")
    assert bool(jnp.all(ref2 == convolve.convolve(a, big)))


def test_match_sparse_path(rng):
    """match_live / match_live_and_dead with host-known patterns take the
    shift-AND sparse path; it must agree with the correlation path."""
    state = board.from_dense(jnp.asarray(random_dense(rng, batch=(3,), p=0.35)))
    live = board.from_cells([(0, 0), (1, 0), (0, 1), (2, 1), (62, 63)])
    dead = board.from_cells([(3, 3), (63, 0), (1, 63)])
    ref = board.from_dense(convolve.correlate_counts(~state, live) == 0)
    assert bool(jnp.all(ref == convolve.match_live(state, live)))
    ref2 = ref & board.from_dense(
        convolve.correlate_counts(state, dead) == 0)
    assert bool(jnp.all(
        ref2 == convolve.match_live_and_dead(state, live, dead)))
    # empty pattern matches every translation
    assert bool(jnp.all(
        convolve.match_live(state, board.empty()) == jnp.uint32(0xFFFFFFFF)))


def test_convolve_counts(rng):
    a = board.from_cells([(0, 0), (1, 0)])
    b = board.from_cells([(0, 0), (1, 0)])
    counts = np.asarray(convolve.convolve_counts(a, b))
    assert counts[1, 0] == 2  # (0,0)+(1,0) and (1,0)+(0,0)
    assert counts[0, 0] == 1 and counts[2, 0] == 1
    assert counts.sum() == 4


def test_convolve_full_board(rng):
    # the reference has a special case for all-ones source words
    a = board.full()
    b = board.from_cells([(3, 4)])
    got = convolve.convolve(a, b)
    assert bool(board.equal(got, board.full()))


def test_match_live(rng):
    pat = board.from_cells(EATER)
    state = board.move(pat, 10, 20) | board.from_cells([(40, 40)])
    m = convolve.match_live(state, pat)
    assert bool(board.get_cell(m, 10, 20))
    # match_live allows extra ON cells elsewhere; exact match forbids
    # boundary cells
    m2 = convolve.match(state, pat)
    assert bool(board.get_cell(m2, 10, 20))
    got = board.on_cells(m2)
    assert got == [(10, 20)]


def test_match_excludes_overlapping_garbage():
    pat = board.from_cells(EATER)
    state = board.move(pat, 10, 20)
    # put garbage directly adjacent: boundary violated -> no match
    state2 = state | board.from_cells([(9, 19)])
    m = convolve.match(state2, pat)
    assert board.on_cells(m) == []


def test_match_target(rng):
    pat = board.from_cells(GLIDER)
    t = target_mod.LifeTarget.from_state(pat)
    state = board.move(pat, 5, 7)
    m = target_mod.match(state, t)
    assert bool(board.get_cell(m, 5, 7))
    assert bool(target_mod.contains(state, t.moved(5, 7)))
    assert bool(target_mod.contains_moved(state, t, 5, 7))
    assert not bool(target_mod.contains(state, t))


def test_hamming_cost():
    pat = board.from_cells(GLIDER)
    t = target_mod.LifeTarget.from_state(pat)
    assert int(target_mod.hamming_cost(pat, t)) == 0
    assert int(target_mod.hamming_cost(board.empty(), t)) == 5
    # a boundary violation costs too
    bad = pat | board.from_cells([(0, 0)])
    assert int(target_mod.hamming_cost(bad, t)) == 1


def test_interaction_offsets_predict_then_simulate():
    # The reference's EaterSelfInteractionTest
    # (tests/InteractionTest.cpp:7-28): for every non-overlapping placement,
    # InteractionOffsets must predict EXACTLY whether the union of the two
    # still lifes fails to be still.
    eater = board.move(rle_parse_eater(), 20, 20)
    offsets_board = convolve.interaction_offsets(eater, eater)
    for dx in range(-10, 10):
        for dy in range(-10, 10):
            moved = board.move(eater, dx, dy)
            if not bool(board.are_disjoint(eater, moved)):
                continue
            together = eater | moved
            interacts = not bool(board.equal(step.step(together), together))
            predicted = bool(board.get_cell(offsets_board, dx, dy))
            assert predicted == interacts, (dx, dy)


def rle_parse_eater():
    from lifeapi_tpu.core import rle

    return rle.parse("2b2o$bobo$bo$2o!")


def test_component_containing():
    blob1 = board.from_cells([(1, 1), (2, 2), (3, 3)])
    blob2 = board.from_cells([(30, 30), (31, 30)])
    state = blob1 | blob2
    comp = convolve.component_containing(state, board.cell_mask(1, 1))
    assert bool(board.equal(comp, blob1))
    comps = convolve.components(state)
    assert len(comps) == 2
    union = comps[0] | comps[1]
    assert bool(board.equal(union, state))


def test_components_vertically_separated():
    # the reference snapshot infinite-loops on this (SURVEY.md section 2.7);
    # we implement the intended semantics
    state = board.from_cells([(5, 5), (5, 8)])
    comps = convolve.components(state)
    assert len(comps) == 2


def test_dft_matches_fft_paths(rng):
    """The matmul-DFT transform and jnp.fft (the default path) must
    produce identical integer counts, including the worst-case magnitudes
    (dense p=0.5 boards and the all-ones board where the spectral DC term
    reaches 4096^2)."""
    cases = []
    for p in (0.05, 0.5):
        cases.append((random_dense(rng, p=p, batch=(4,)),
                      random_dense(rng, p=p, batch=(4,))))
    ones = np.ones((1, 64, 64), bool)
    cases.append((ones, ones))
    for da, db in cases:
        a = board.from_dense(jnp.asarray(da))
        b = board.from_dense(jnp.asarray(db))
        via_fft = np.asarray(convolve.convolve_counts(a, b, method="fft"))
        via_dft = np.asarray(convolve.convolve_counts(a, b, method="dft"))
        assert (via_fft == via_dft).all()
        or_fft = np.asarray(convolve.convolve(a, b, method="fft"))
        or_dft = np.asarray(convolve.convolve(a, b, method="dft"))
        assert (or_fft == or_dft).all()


def test_ntt_matches_brute_force(rng):
    """The two-prime NTT path is bit-exact BY
    CONSTRUCTION (single-pass bf16 matmuls over integers <= 256 with f32
    accumulation never exceed 2^24); verify against a brute-force numpy
    convolution and the fft path, including the all-ones worst case
    (every count = 4096, the CRT range maximum in play)."""
    def brute(da, db):
        out = np.zeros((64, 64), np.int32)
        for x, y in zip(*np.nonzero(da)):
            out += np.roll(np.roll(db, x, axis=0), y, axis=1)
        return out

    cases = []
    for p in (0.05, 0.5):
        cases.append((random_dense(rng, p=p, batch=(2,)),
                      random_dense(rng, p=p, batch=(2,))))
    ones = np.ones((1, 64, 64), bool)
    cases.append((ones, ones))
    for da, db in cases:
        a = board.from_dense(jnp.asarray(da))
        b = board.from_dense(jnp.asarray(db))
        via_ntt = np.asarray(convolve.convolve_counts(a, b, method="ntt"))
        via_fft = np.asarray(convolve.convolve_counts(a, b, method="fft"))
        assert (via_ntt == via_fft).all()
        expect = np.stack([brute(da[i], db[i]) for i in range(len(da))])
        assert (via_ntt == expect).all()
        or_ntt = np.asarray(convolve.convolve(a, b, method="ntt"))
        assert (or_ntt == np.asarray(convolve.convolve(a, b, method="fft"))).all()


def test_ntt_odd_batch_and_worst_case(rng):
    """The two-prime NTT counts (exact by construction) on odd batches
    and the all-ones worst case (every count 4096), against the FFT."""
    for p, B in ((0.1, 3), (0.5, 5)):
        a = board.from_dense(jnp.asarray(random_dense(rng, p=p, batch=(B,))))
        b = board.from_dense(jnp.asarray(random_dense(rng, p=p, batch=(B,))))
        got = np.asarray(convolve.convolve_counts(a, b, method="ntt"))
        exp = np.asarray(convolve.convolve_counts(a, b, method="fft"))
        assert (got == exp).all()
    ones = board.from_dense(jnp.ones((2, 64, 64), bool))
    got = np.asarray(convolve.convolve_counts(ones, ones, method="ntt"))
    assert (got == 4096).all()


def test_counts_small_operands_all_methods(rng):
    """Pattern-family operands (populations far below 193): counts and OR
    agree across the fft, ntt and dft transforms and a brute-force count,
    odd batch included."""
    def brute(da, db):
        out = np.zeros((64, 64), np.int64)
        for x, y in zip(*np.nonzero(da)):
            out += np.roll(np.roll(db, x, axis=0), y, axis=1)
        return out

    for B in (3, 4):
        da = random_dense(rng, p=0.04, batch=(B,))
        db = random_dense(rng, p=0.04, batch=(B,))
        a = board.from_dense(jnp.asarray(da))
        b = board.from_dense(jnp.asarray(db))
        exp = np.stack([brute(da[i], db[i]) for i in range(B)])
        for method in ("fft", "ntt", "dft"):
            got = np.asarray(convolve.convolve_counts(a, b, method=method))
            assert (got == exp).all(), method
            got_or = np.asarray(board.to_dense(
                convolve.convolve(a, b, method=method)))
            assert (got_or == (exp > 0)).all(), method


def test_convolve_wrap_heavy_cells():
    """OR-convolution of torus-edge cells wraps identically on every
    dense transform (odd and even batches)."""
    a = jnp.stack([board.from_cells([(63, 63), (0, 0), (31, 32)]),
                   board.from_cells([(1, 2)])])
    b = jnp.stack([board.from_cells([(63, 1)]),
                   board.from_cells([(2, 63), (33, 31)])])
    want = [{(62, 0), (63, 1), (30, 33)}, {(3, 1), (34, 33)}]
    for method in ("fft", "ntt", "dft"):
        got = convolve.convolve(a, b, method=method)
        for i in range(2):
            cells = {tuple(map(int, c)) for c in board.on_cells(got[i])}
            assert cells == want[i], (method, i)


def test_convolve_sparse_device_matches_fft(rng):
    """The device-side extraction loop (traced-operand sparse path) must
    equal the dense transform convolution for per-board random sparse
    operands, including empty ones, in and out of jit."""
    import jax

    B = 12
    da = rng.random((B, 64, 64)) < 0.1
    db = np.zeros((B, 64, 64), bool)
    for i in range(B):
        k = int(rng.integers(0, 11))
        if k:
            db[i, rng.integers(0, 64, k), rng.integers(0, 64, k)] = True
    a = board.from_dense(jnp.asarray(da))
    b = board.from_dense(jnp.asarray(db))
    ref = np.asarray(convolve.convolve(a, b, method="fft"))
    got = np.asarray(convolve.convolve_sparse_device(a, b))
    assert (got == ref).all()
    got_jit = np.asarray(
        jax.jit(lambda a, b: convolve.convolve(a, b, method="sparse"))(a, b)
    )
    assert (got_jit == ref).all()
    # auto-dispatch: concrete batched sparse operand takes this path
    assert (np.asarray(convolve.convolve(a, b)) == ref).all()


def test_convolve_sparse_device_edge_cases(rng):
    """The XLA peel loop (convolve_sparse_device) equals the FFT OR for
    random per-board sparse operands, empty operands, a dense lane, and
    unbatched broadcast shapes."""
    B = 12
    da = rng.random((B, 64, 64)) < 0.1
    db = np.zeros((B, 64, 64), bool)
    for i in range(B):
        k = int(rng.integers(0, 11))
        if k:
            db[i, rng.integers(0, 64, k), rng.integers(0, 64, k)] = True
    db[3][:] = True  # one dense lane: loop must still terminate exactly
    a = board.from_dense(jnp.asarray(da))
    b = board.from_dense(jnp.asarray(db))
    ref = np.asarray(convolve.convolve(a, b, method="fft"))
    got = np.asarray(convolve.convolve_sparse_device(a, b))
    assert (got == ref).all()

    empty = jnp.zeros((B, 64, 2), jnp.uint32)
    assert (np.asarray(convolve.convolve_sparse_device(a, empty)) == 0).all()

    a1 = board.from_dense(jnp.asarray(rng.random((64, 64)) < 0.1))
    b1 = board.from_cells([(3, 5), (60, 62), (0, 0), (63, 31), (31, 63)])
    r1 = np.asarray(convolve.convolve(a1, b1, method="fft"))
    o1 = np.asarray(convolve.convolve_sparse_device(a1, b1))
    assert (o1 == r1).all()


def test_convolve_counts_sparse_device(rng):
    """Bit-sliced peel counts (round 5): exact vs the FFT counts for
    random sparse operands, via explicit method, auto-dispatch, and jit;
    empty operands give all-zero counts."""
    import jax

    B = 6
    da = rng.random((B, 64, 64)) < 0.15
    db = np.zeros((B, 64, 64), bool)
    for i in range(B):
        k = int(rng.integers(0, 12))
        if k:
            db[i, rng.integers(0, 64, k), rng.integers(0, 64, k)] = True
    a = board.from_dense(jnp.asarray(da))
    b = board.from_dense(jnp.asarray(db))
    ref = np.asarray(convolve.convolve_counts(a, b, method="fft"))
    assert (np.asarray(
        convolve.convolve_counts(a, b, method="sparse")) == ref).all()
    assert (np.asarray(convolve.convolve_counts(a, b)) == ref).all()
    got_j = np.asarray(jax.jit(
        lambda a, b: convolve.convolve_counts(a, b, method="sparse"))(a, b))
    assert (got_j == ref).all()
    empty = jnp.zeros((B, 64, 2), jnp.uint32)
    assert (np.asarray(
        convolve.convolve_counts(a, empty, method="sparse")) == 0).all()


def test_interaction_offsets_routes_agree(rng):
    """Round 5: the dense (stacked NTT/FFT), concrete-sparse (shift-OR)
    and traced-sparse (stacked peel with min-side swap) routes of
    interaction_offsets must be bit-identical, batched and unbatched."""
    import jax

    from lifeapi_tpu.core import rle
    from lifeapi_tpu.symmetry import transforms as tr
    from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T

    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(
        tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)

    dense = np.asarray(jax.jit(
        lambda a, b: convolve.interaction_offsets(a, b))(glider, eater))
    auto = np.asarray(convolve.interaction_offsets(glider, eater))
    sp = np.asarray(jax.jit(
        lambda a, b: convolve.interaction_offsets(a, b, method="sparse"))(
            glider, eater))
    assert (dense == auto).all()
    assert (dense == sp).all()

    d = np.zeros((4, 64, 64), bool)
    for i in range(4):
        d[i, rng.integers(10, 50, 6), rng.integers(10, 50, 6)] = True
    bb = board.from_dense(jnp.asarray(d))
    aa = jnp.broadcast_to(glider, (4, 64, 2))
    dense_b = np.asarray(jax.jit(
        lambda a, b: convolve.interaction_offsets(a, b))(aa, bb))
    sp_b = np.asarray(jax.jit(
        lambda a, b: convolve.interaction_offsets(a, b, method="sparse"))(
            aa, bb))
    assert (dense_b == sp_b).all()


def test_counts_sparse_device_planes(rng):
    """The bit-sliced ripple-add counts equal the FFT counts for random
    sparse operands, with the minimal plane width for a proven bound."""
    B = 6
    da = rng.random((B, 64, 64)) < 0.15
    db = np.zeros((B, 64, 64), bool)
    for i in range(B):
        k = int(rng.integers(0, 12))
        if k:
            db[i, rng.integers(0, 64, k), rng.integers(0, 64, k)] = True
    a = board.from_dense(jnp.asarray(da))
    b = board.from_dense(jnp.asarray(db))
    ref = np.asarray(convolve.convolve_counts(a, b, method="fft"))
    assert (np.asarray(convolve.convolve_counts_sparse_device(a, b))
            == ref).all()
    bounded = convolve.convolve_counts_sparse_device(a, b, max_cells=11)
    assert (np.asarray(bounded) == ref).all()


def test_counts_sparse_dense_operand_exact(rng):
    """Round-5 fuzz finding: method="sparse" counts must be exact for
    ANY operand population (the old 6-plane default wrapped mod 64 on
    dense operands); the auto-width default must cover counts > 63."""
    B = 3
    da = rng.random((B, 64, 64)) < 0.3
    db = rng.random((B, 64, 64)) < 0.5
    a = board.from_dense(jnp.asarray(da))
    b = board.from_dense(jnp.asarray(db))
    ref = np.asarray(convolve.convolve_counts(a, b, method="fft"))
    got = np.asarray(convolve.convolve_counts(a, b, method="sparse"))
    assert ref.max() > 63  # exercises widths beyond 6 bits
    assert (got == ref).all()


def test_conv_sparse_fused_param_variants(rng):
    """n_planes variants stay bit-identical to the FFT counts (wider
    counters only change headroom)."""
    B = 5
    da = rng.random((B, 64, 64)) < 0.1
    db = np.zeros((B, 64, 64), bool)
    for i in range(B):
        db[i, rng.integers(0, 64, 7), rng.integers(0, 64, 7)] = True
    a = board.from_dense(jnp.asarray(da))
    b = board.from_dense(jnp.asarray(db))
    cref = np.asarray(convolve.convolve_counts(a, b, method="fft"))
    for n_planes in (3, 6, 13):
        got = np.asarray(convolve.convolve_counts_sparse_device(
            a, b, n_planes=n_planes))
        assert (got == cref).all(), n_planes
