"""The vectorized closed-form rules (stable/rules_vec.py — the device path)
must agree with the scalar rule functions (stable/options.py — the
specification) on the full input grid."""

import numpy as np
import jax.numpy as jnp

from lifeapi_tpu.stable import options as opt
from lifeapi_tpu.stable import rules_vec as rv


def _valid_grid():
    """All (center, on9, unk9) combos the window can actually produce."""
    combos = []
    for center in (opt.OFF, opt.ON, opt.UNKNOWN):
        for on9 in range(10):
            for unk9 in range(10 - on9):
                nc = opt._neighbour_counts(center, on9, unk9)
                if nc is None:
                    continue
                if sum(nc) > 8:
                    continue
                combos.append((center, on9, unk9))
    return combos


def test_update_bits_matches_rule():
    combos = _valid_grid()
    c = jnp.asarray([x[0] for x in combos])
    on9 = jnp.asarray([x[1] for x in combos])
    unk9 = jnp.asarray([x[2] for x in combos])
    add, abort = rv.update_bits(c, on9, unk9)
    add, abort = np.asarray(add), np.asarray(abort)
    for i, (center, o9, u9) in enumerate(combos):
        mask, ab = opt.update_options_rule(center, o9, u9)
        assert bool(abort[i]) == ab, (center, o9, u9)
        if not ab:
            assert int(add[i]) == mask, (center, o9, u9)


def test_simple_bits_matches_rule():
    combos = _valid_grid()
    c = jnp.asarray([x[0] for x in combos])
    on9 = jnp.asarray([x[1] for x in combos])
    unk9 = jnp.asarray([x[2] for x in combos])
    bits = np.asarray(rv.simple_bits(c, on9, unk9))
    for i, (center, o9, u9) in enumerate(combos):
        nc = opt._neighbour_counts(center, o9, u9)
        so, sn, gf, gn, ab = opt.simple_rule(center, *nc)
        expect = so | (sn << 1) | (gf << 2) | (gn << 3) | (ab << 4)
        assert int(bits[i]) == expect, (center, o9, u9, int(bits[i]), expect)


def test_ternary_code_matches_rule():
    combos = _valid_grid()
    c = jnp.asarray([x[0] for x in combos])
    on9 = jnp.asarray([x[1] for x in combos])
    unk9 = jnp.asarray([x[2] for x in combos])
    for naive in (False, True):
        got = np.asarray(rv.ternary_code(c, on9, unk9, naive=naive))
        for i, (center, o9, u9) in enumerate(combos):
            nc = opt._neighbour_counts(center, o9, u9)
            expect = opt.life_rule_interval(center, *nc, naive=naive)
            assert int(got[i]) == expect, (center, o9, u9, naive)


def test_signal_bits_matches_rule():
    combos = _valid_grid()
    masks = list(range(256))
    cs, o9s, u9s, ms = [], [], [], []
    for center, on9, unk9 in combos:
        for m in masks:
            cs.append(center)
            o9s.append(on9)
            u9s.append(unk9)
            ms.append(m)
    c = jnp.asarray(cs)
    on9 = jnp.asarray(o9s)
    unk9 = jnp.asarray(u9s)
    m = jnp.asarray(ms, dtype=jnp.uint8)
    got = np.asarray(rv.signal_bits(c, m, on9, on9 + unk9))
    i = 0
    for center, on9_, unk9_ in combos:
        nc = opt._neighbour_counts(center, on9_, unk9_)
        n = opt.Nbhd(center, *nc)
        for mask in masks:
            sn, sf, cn, cf = opt.signal_rule(mask, n)
            expect = sn | (sf << 1) | (cn << 2) | (cf << 3)
            assert int(got[i]) == expect, (center, on9_, unk9_, mask,
                                           int(got[i]), expect)
            i += 1


def test_vulnerable_bits_matches_rule():
    combos = _valid_grid()
    # sample masks (full 256 x combos is fine too but slower in the scalar
    # reference loop); include structured + random masks
    rng = np.random.default_rng(0)
    masks = sorted(set(range(0, 256, 7)) | {0, 0xFF, opt.LIVE_MASK,
                                            opt.DEAD_MASK}
                   | set(rng.integers(0, 256, 40).tolist()))
    cs, o9s, u9s, ms = [], [], [], []
    for center, on9, unk9 in combos:
        for m in masks:
            cs.append(center)
            o9s.append(on9)
            u9s.append(unk9)
            ms.append(m)
    got = np.asarray(
        rv.vulnerable_bits(
            jnp.asarray(cs), jnp.asarray(ms, dtype=jnp.uint8),
            jnp.asarray(o9s), jnp.asarray(u9s),
        )
    )
    i = 0
    for center, on9_, unk9_ in combos:
        nc = opt._neighbour_counts(center, on9_, unk9_)
        n = opt.Nbhd(center, *nc)
        for mask in masks:
            vo, vf, vco, vcf = opt.vulnerable_rule(mask, n)
            if center != opt.UNKNOWN:
                vco = vcf = 0  # center branch only defined for unknown cells
            expect = vo | (vf << 1) | (vco << 2) | (vcf << 3)
            assert int(got[i]) == expect, (center, on9_, unk9_, mask,
                                           int(got[i]), expect)
            i += 1
