"""Still-life option algebra and lookup-table generation.

A *stable* cell is ON with 2-3 ON neighbours, or OFF with 0, 1, 2, 4, 5 or
6 ON neighbours (OFF with 3 would be a birth; ON otherwise dies).  The
per-cell domain is the option set {LIVE2, LIVE3, DEAD0, DEAD1, DEAD2,
DEAD4, DEAD5, DEAD6} (reference LifeStable.hpp:7-20).  Options are stored
*inverted* — bit set means ruled out — matching the reference's plane
convention (LifeStable.hpp:44-53).

The reference compiles per-cell propagation rules to espresso-minimized
boolean netlists executed bit-sliced over 64-bit words
(bitslicing/common.py + stable_*.py generators).  Here, cell domains live
densely (uint8 per cell) and the same rule functions become small lookup
tables evaluated by vectorized gathers — this module derives
those tables directly from the semantics (interval reasoning over unknown
neighbour counts), not from the committed netlists.  Each table is
exhaustively checked against an independent brute-force enumeration in
tests/test_stable_luts.py.
"""

from __future__ import annotations

import numpy as np

# Option bit assignments (reference LifeStable.hpp:7-20)
LIVE2 = 1 << 0
LIVE3 = 1 << 1
DEAD0 = 1 << 2
DEAD1 = 1 << 3
DEAD2 = 1 << 4
DEAD4 = 1 << 5
DEAD5 = 1 << 6
DEAD6 = 1 << 7

LIVE_MASK = LIVE2 | LIVE3
DEAD_MASK = DEAD0 | DEAD1 | DEAD2 | DEAD4 | DEAD5 | DEAD6
IMPOSSIBLE = 0

# option bit -> (center is live, neighbour count)
OPTION_SEMANTICS = {
    LIVE2: (True, 2),
    LIVE3: (True, 3),
    DEAD0: (False, 0),
    DEAD1: (False, 1),
    DEAD2: (False, 2),
    DEAD4: (False, 4),
    DEAD5: (False, 5),
    DEAD6: (False, 6),
}

# three-state center encodings used for LUT indices
OFF, ON, UNKNOWN = 0, 1, 2


def options_highest(mask_possible):
    """Highest-order set bit of a *possible*-sense options mask (reference
    ``StableOptionsHighest``, LifeStable.hpp:22-27); 0 for IMPOSSIBLE."""
    if mask_possible == 0:
        return 0
    return 1 << (mask_possible.bit_length() - 1)


def is_singleton(mask_possible):
    """Exactly one option remains (reference ``SingletonOptions``,
    LifeStable.hpp:93-96)."""
    return mask_possible != 0 and (mask_possible & (mask_possible - 1)) == 0


def possible_neighbourhoods(mask):
    """(center_live, count) pairs still allowed by an options mask (mask
    uses the *possible* sense here: bit set in ``mask`` = ruled OUT)."""
    return [sem for bit, sem in OPTION_SEMANTICS.items() if not (mask & bit)]


def three_state(mask):
    """ON/OFF/UNKNOWN from an options mask (reference common.py
    to_three_state)."""
    maybe_live = (mask & LIVE_MASK) != LIVE_MASK
    maybe_dead = (mask & DEAD_MASK) != DEAD_MASK
    if maybe_live and not maybe_dead:
        return ON
    if maybe_dead and not maybe_live:
        return OFF
    return UNKNOWN


class Nbhd:
    """Interval knowledge about a cell: center three-state, known-ON
    neighbour count, and number of unknown neighbours (reference
    common.py CellUnknownNeighbourhood)."""

    __slots__ = ("center", "count", "unknown")

    def __init__(self, center, count, unknown):
        self.center = center
        self.count = count
        self.unknown = unknown

    def meet(self, other):
        if self.center == other.center:
            center = self.center
        elif self.center == UNKNOWN:
            center = other.center
        elif other.center == UNKNOWN:
            center = self.center
        else:
            return None
        known_ons = max(self.count, other.count)
        known_offs = max(
            8 - self.unknown - self.count, 8 - other.unknown - other.count
        )
        remaining = 8 - known_ons - known_offs
        return Nbhd(center, known_ons, remaining)


def maximal_options(n: Nbhd):
    """Most permissive options mask consistent with the interval
    (reference common.py maximal_options); returns a ruled-out mask."""
    lo, hi = n.count, n.count + n.unknown
    mask = 0
    for bit, (live, cnt) in OPTION_SEMANTICS.items():
        if not (lo <= cnt <= hi):
            mask |= bit
        if n.center == ON and not live:
            mask |= bit
        if n.center == OFF and live:
            mask |= bit
    return mask


def options_to_nbhd(mask):
    """Options mask -> interval knowledge (reference common.py
    to_unknown_neighbourhood).  mask must not be IMPOSSIBLE-complete."""
    counts = [cnt for _, cnt in possible_neighbourhoods(mask)]
    return Nbhd(three_state(mask), min(counts), max(counts) - min(counts))


def restrict_options(mask, n: Nbhd):
    """o.restrict_to(n): meet with the interval's maximal options."""
    return mask | maximal_options(n)


def restrict_nbhd(n: Nbhd, mask):
    """n.restrict_to(o): meet of intervals; None if contradictory."""
    if mask == 0xFF:
        return None
    return n.meet(options_to_nbhd(mask))


def life_stable(center_live, count):
    if center_live:
        return count in (2, 3)
    return count != 3


# ---------------------------------------------------------------------------
# Rule functions (semantics of the reference's generated netlists)
# ---------------------------------------------------------------------------


def update_options_rule(center, on9, unk9):
    """Option pruning from counts (semantics of bitslicing/stable_count.py
    options_function; consumed at LifeStable.hpp:591, :1162).

    on9/unk9 are 9-cell window counts INCLUDING the center.  Returns
    (ruled_out_mask, abort)."""
    if center == ON:
        lo = on9 - 1
        hi = on9 - 1 + unk9
        if hi < 2 or lo > 3:
            return 0, True
        mask = DEAD_MASK
        if not (lo <= 2 <= hi):
            mask |= LIVE2
        if not (lo <= 3 <= hi):
            mask |= LIVE3
        return mask, False
    if center == OFF:
        lo = on9
        hi = on9 + unk9
        if lo == 3 and hi == 3:
            return 0, True
        if lo > 6:
            return 0, True
        mask = LIVE_MASK
        for bit, (_, cnt) in OPTION_SEMANTICS.items():
            if bit in (LIVE2, LIVE3):
                continue
            if not (lo <= cnt <= hi):
                mask |= bit
        return mask, False
    # UNKNOWN center: the center itself is one of the unknowns
    lo = on9
    hi = on9 + unk9 - 1
    if lo > 6:
        return 0, True
    mask = 0
    for bit, (_, cnt) in OPTION_SEMANTICS.items():
        if not (lo <= cnt <= hi):
            mask |= bit
    return mask, False


def simple_rule(center, on_n, unk_n):
    """State/unknown-only propagation (semantics of
    bitslicing/stable_simple.py propagate_function; consumed at
    LifeStable.hpp:453, :819).

    on_n/unk_n are NEIGHBOUR counts (center excluded).  Returns bits
    (set_off, set_on, signal_off, signal_on, abort)."""
    outcomes = []
    for i in range(on_n, on_n + unk_n + 1):
        this_on = center in (ON, UNKNOWN) and life_stable(True, i)
        this_off = center in (OFF, UNKNOWN) and life_stable(False, i)
        if this_on and this_off:
            outcomes.append("U")
        elif this_on:
            outcomes.append("N")
        elif this_off:
            outcomes.append("F")
        else:
            outcomes.append("A")

    maybe_on = any(c in "NU" for c in outcomes)
    maybe_off = any(c in "FU" for c in outcomes)

    if center == UNKNOWN:
        if maybe_on and not maybe_off:
            return (0, 1, 0, 0, 0)
        if maybe_off and not maybe_on:
            return (1, 0, 0, 0, 0)
    if center == ON and not maybe_on:
        return (0, 0, 0, 0, 1)
    if center == OFF and not maybe_off:
        return (0, 0, 0, 0, 1)

    if unk_n > 0:
        # The only consistent count is at one end of the interval: every
        # unknown neighbour is forced (all-ON or all-OFF).
        if center == ON and outcomes[-1] == "N" and all(c in "FA" for c in outcomes[:-1]):
            return (0, 0, 0, 1, 0)
        if center == OFF and outcomes[-1] == "F" and all(c in "NA" for c in outcomes[:-1]):
            return (0, 0, 0, 1, 0)
        if center == ON and outcomes[0] == "N" and all(c in "FA" for c in outcomes[1:]):
            return (0, 0, 1, 0, 0)
        if center == OFF and outcomes[0] == "F" and all(c in "NA" for c in outcomes[1:]):
            return (0, 0, 1, 0, 0)

    return (0, 0, 0, 0, 0)


def signal_rule(mask, n: Nbhd):
    """Neighbour forcing from options (semantics of
    bitslicing/stable_signal.py new_signal_function/new_center_function;
    consumed at LifeStable.hpp:654, :1047).

    Returns bits (signal_on, signal_off, center_on, center_off); don't-care
    situations return all zeros (sound: signalling nothing never prunes)."""
    signal_on = signal_off = center_on = center_off = 0

    if n.unknown != 0:
        o2 = restrict_options(mask, n)
        if o2 != 0xFF:
            n2 = restrict_nbhd(n, o2)
            if n2 is not None:
                n3 = restrict_nbhd(n, mask)
                if n3 is not None and n3.unknown == 0:
                    if n3.count == n.count:
                        signal_off = 1
                    elif n3.count == n.count + n.unknown:
                        signal_on = 1

    if n.center == UNKNOWN:
        o2 = restrict_options(mask, n)
        if o2 != 0xFF:
            n2 = restrict_nbhd(n, o2)
            if n2 is not None:
                if n2.center == ON:
                    center_on = 1
                elif n2.center == OFF:
                    center_off = 1

    return (signal_on, signal_off, center_on, center_off)


def _is_forced(mask, n: Nbhd):
    """None = contradiction, True = everything about the cell is decided
    (reference stable_vulnerable.py is_forced)."""
    center_unknown = n.center == UNKNOWN
    o2 = restrict_options(mask, n)
    if o2 == 0xFF:
        return None
    n2 = restrict_nbhd(n, o2)
    if n2 is None:
        return None
    return n2.unknown == 0 or (center_unknown and n2.center != UNKNOWN)


def vulnerable_rule(mask, n: Nbhd):
    """Branch-point heuristic (semantics of bitslicing/stable_vulnerable.py;
    consumed at LifeStable.hpp:400).  Returns (v_on, v_off, vc_on, vc_off):
    whether assigning an unknown neighbour (or the center) ON/OFF would
    force or contradict the cell."""
    v_on = v_off = 0
    if not (
        (n.center != UNKNOWN and n.unknown <= 1)
        or (n.center == UNKNOWN and n.unknown == 0)
    ):
        f_on = _is_forced(mask, Nbhd(n.center, n.count + 1, n.unknown - 1))
        f_off = _is_forced(mask, Nbhd(n.center, n.count, n.unknown - 1))
        v_on = 1 if (f_on is None or f_on) else 0
        v_off = 1 if (f_off is None or f_off) else 0

    vc_on = vc_off = 0
    if n.unknown != 0 and n.center == UNKNOWN:
        f_on = _is_forced(mask, Nbhd(ON, n.count, n.unknown))
        f_off = _is_forced(mask, Nbhd(OFF, n.count, n.unknown))
        vc_on = 1 if (f_on is None or f_on) else 0
        vc_off = 1 if (f_off is None or f_off) else 0

    return (v_on, v_off, vc_on, vc_off)


def life_rule_interval(center, on_n, unk_n, naive=False):
    """Ternary (three-state) Life step over neighbour-count intervals
    (semantics of the reference's dormant bitslicing/unknown_step.py
    stepactive_function; SURVEY.md section 2.6).  Returns OFF/ON/UNKNOWN.

    ``naive=True`` reproduces the reference generator's early return
    (unknown centers stay unknown); the default also resolves unknown
    centers whose fate is identical either way (e.g. overcrowded cells die
    regardless) — the refinement unknown_step_refined.py aims at."""
    if naive and center == UNKNOWN:
        return UNKNOWN
    maybe_on = maybe_off = False
    for i in range(on_n, on_n + unk_n + 1):
        if center in (ON, UNKNOWN):
            nxt = i in (2, 3)
            maybe_on |= nxt
            maybe_off |= not nxt
        if center in (OFF, UNKNOWN):
            nxt = i == 3
            maybe_on |= nxt
            maybe_off |= not nxt
    if maybe_on and maybe_off:
        return UNKNOWN
    return ON if maybe_on else OFF


# ---------------------------------------------------------------------------
# LUT builders (cached in-process)
# ---------------------------------------------------------------------------

_cache = {}


def _counts_iter():
    for on9 in range(10):
        for unk9 in range(10 - on9):
            yield on9, unk9


def _neighbour_counts(center, on9, unk9):
    """9-cell inclusive counts -> neighbour counts, or None if impossible."""
    on_n = on9 - (1 if center == ON else 0)
    unk_n = unk9 - (1 if center == UNKNOWN else 0)
    if on_n < 0 or unk_n < 0:
        return None
    return on_n, unk_n


def update_lut():
    """uint16[3, 10, 10]: low 8 bits ruled-out mask, bit 8 abort.  Indexed
    by (center, on9, unk9) — 9-cell counts including the center."""
    if "update" not in _cache:
        lut = np.zeros((3, 10, 10), dtype=np.uint16)
        for center in (OFF, ON, UNKNOWN):
            for on9, unk9 in _counts_iter():
                if _neighbour_counts(center, on9, unk9) is None:
                    continue
                mask, abort = update_options_rule(center, on9, unk9)
                lut[center, on9, unk9] = mask | (0x100 if abort else 0)
        _cache["update"] = lut
    return _cache["update"]


def simple_lut():
    """uint8[3, 10, 10]: bits (1=set_off, 2=set_on, 4=signal_off,
    8=signal_on, 16=abort), indexed by (center, on9, unk9)."""
    if "simple" not in _cache:
        lut = np.zeros((3, 10, 10), dtype=np.uint8)
        for center in (OFF, ON, UNKNOWN):
            for on9, unk9 in _counts_iter():
                nc = _neighbour_counts(center, on9, unk9)
                if nc is None:
                    continue
                so, sn, gf, gn, ab = simple_rule(center, *nc)
                lut[center, on9, unk9] = (
                    so | (sn << 1) | (gf << 2) | (gn << 3) | (ab << 4)
                )
        _cache["simple"] = lut
    return _cache["simple"]


def signal_lut():
    """uint8[3, 256, 10, 10]: bits (1=signal_on, 2=signal_off, 4=center_on,
    8=center_off), indexed by (center, options_mask, on9, m9) where
    m9 = on9 + unk9 (count of state|unknown, matching the reference's
    maxCount input, LifeStable.hpp:619)."""
    if "signal" not in _cache:
        lut = np.zeros((3, 256, 10, 10), dtype=np.uint8)
        for center in (OFF, ON, UNKNOWN):
            for on9, unk9 in _counts_iter():
                nc = _neighbour_counts(center, on9, unk9)
                if nc is None:
                    continue
                n = Nbhd(center, *nc)
                m9 = on9 + unk9
                for mask in range(256):
                    sn, sf, cn, cf = signal_rule(mask, n)
                    lut[center, mask, on9, m9] = (
                        sn | (sf << 1) | (cn << 2) | (cf << 3)
                    )
        _cache["signal"] = lut
    return _cache["signal"]


def vulnerable_lut():
    """uint8[256, 10, 10]: bits (1=v_on, 2=v_off, 4=vc_on, 8=vc_off),
    indexed by (options_mask, on9, unk9).  Enumerated exactly like the
    reference generator: only options compatible with the interval are
    populated (others read 0)."""
    if "vulnerable" not in _cache:
        lut = np.zeros((256, 10, 10), dtype=np.uint8)
        for center in (OFF, ON, UNKNOWN):
            for on9, unk9 in _counts_iter():
                nc = _neighbour_counts(center, on9, unk9)
                if nc is None:
                    continue
                n = Nbhd(center, *nc)
                base = maximal_options(n)
                if base == 0xFF:
                    continue
                # upperset of the maximal options (reference
                # compatible_options): any mask that keeps a nonempty
                # subset of the allowed options
                for mask in range(256):
                    if (mask & base) != base:
                        continue  # allows something the interval forbids
                    if mask == 0xFF:
                        continue
                    if center == UNKNOWN and three_state(mask) != UNKNOWN:
                        continue
                    vo, vf, vco, vcf = vulnerable_rule(mask, n)
                    lut[mask, on9, unk9] = (
                        vo | (vf << 1) | (vco << 2) | (vcf << 3)
                    )
        _cache["vulnerable"] = lut
    return _cache["vulnerable"]


def ternary_lut(naive=False):
    """uint8[3, 10, 10] -> next three-state code, indexed by (center, on9,
    unk9)."""
    key = ("ternary", naive)
    if key not in _cache:
        lut = np.zeros((3, 10, 10), dtype=np.uint8)
        for center in (OFF, ON, UNKNOWN):
            for on9, unk9 in _counts_iter():
                nc = _neighbour_counts(center, on9, unk9)
                if nc is None:
                    continue
                lut[center, on9, unk9] = life_rule_interval(center, *nc, naive=naive)
        _cache[key] = lut
    return _cache[key]
