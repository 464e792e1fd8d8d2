"""Strip and patch views: small column windows and square patches packed
into words (reference LifeStrip.hpp and LifeAPI.hpp:148-207).

Here the solver operates whole-board data-parallel, so strips are not a
performance feature here (SURVEY.md section 7); these exist for API parity
and host-side search drivers.
"""

from __future__ import annotations

import numpy as np

from .board import N, torus_wrap

STRIP_WIDTH = 4  # the reference's LifeStateStrip width (LifeStrip.hpp:10)


def _offset(width):
    # 0, 0, 1, 1, 2, 2 for widths 1..6 (reference LifeAPI.hpp:151)
    return (width - 1) // 2


def get_strip(board, column, width=STRIP_WIDTH):
    """uint32[width, 2]: the columns of a width-window centered per the
    reference's offset rule (reference ``GetStrip``, LifeAPI.hpp:148-165)."""
    import jax.numpy as jnp

    off = _offset(width)
    cols = [(column + i - off) % N for i in range(width)]
    return jnp.stack([board[..., c, :] for c in cols], axis=-2)


def set_strip(board, column, value, width=None):
    """Write a strip back (reference ``SetStrip``, LifeAPI.hpp:167-174)."""
    width = width or value.shape[-2]
    off = _offset(width)
    out = board
    for i in range(width):
        c = (column + i - off) % N
        out = out.at[..., c, :].set(value[..., i, :])
    return out


def get_patch(board, cell, radius):
    """Pack the (2r+1)^2 patch around ``cell`` into a Python int, row i
    (column offset) in bit group i*(2r+1) (reference ``GetPatch``,
    LifeAPI.hpp:179-193).  Host-side."""
    from .board import to_dense

    x, y = cell
    d = np.asarray(to_dense(board))
    diameter = 2 * radius + 1
    result = 0
    for i in range(diameter):
        c = torus_wrap(x + i - radius)
        for j in range(diameter):
            r = torus_wrap(y + j - radius)
            if d[c, r]:
                result |= 1 << (i * diameter + j)
    return result


def set_patch(board, cell, radius, value):
    """Inverse of get_patch (reference ``SetPatch``, LifeAPI.hpp:195-207).
    Host-side."""
    import jax.numpy as jnp

    from .board import from_dense, to_dense

    x, y = cell
    d = np.array(to_dense(board))
    diameter = 2 * radius + 1
    for i in range(diameter):
        c = torus_wrap(x + i - radius)
        for j in range(diameter):
            r = torus_wrap(y + j - radius)
            d[c, r] = bool((value >> (i * diameter + j)) & 1)
    return from_dense(jnp.asarray(d))


def strip_indices(column_mask, width=STRIP_WIDTH):
    """Iterate window start columns covering the set bits of a 64-bit column
    mask, clamped so windows don't wrap (reference ``StripIterator``,
    LifeStrip.hpp:102-149).  ``column_mask`` is an int bitmask of columns."""
    out = []
    mask = column_mask
    off = _offset(width)
    while mask:
        lsb = (mask & -mask).bit_length() - 1
        start = min(max(lsb - off, 0), N - width)
        out.append(start)
        covered = ((1 << width) - 1) << start
        mask &= ~covered
    return out
