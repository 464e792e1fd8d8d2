"""LifeStable: object wrapper with the reference's method surface
(reference LifeStable.hpp:39-215) over the batched dense solver state."""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from ..core import board as B
from . import complete as C
from . import host as HO
from . import options as opt
from . import propagate as P


@jax.tree_util.register_pytree_node_class
class LifeStable:
    __slots__ = ("data",)

    def __init__(self, data: P.Stable = None):
        if data is None:
            data = P.make()
        self.data = data

    def tree_flatten(self):
        return (self.data,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_boards(state=None, unknown=None, batch=()):
        """state/unknown: packed boards or dense masks."""
        return LifeStable(P.make(state=state, unknown=unknown, batch=batch))

    # -- plane views (reference stores inverted bit planes,
    #    LifeStable.hpp:44-53) ---------------------------------------------
    @property
    def state(self):
        return B.from_dense(self.data.state)

    @property
    def unknown(self):
        return B.from_dense(self.data.unknown)

    def plane(self, name):
        """Packed 'ruled out' plane by option name: live2, live3, dead0..."""
        bit = getattr(opt, name.upper())
        return B.from_dense((self.data.ruled & bit) != 0)

    # -- cell ops ----------------------------------------------------------
    def get_options(self, cell):
        return P.get_options(self.data, *cell)

    def singleton_options(self, cell):
        """Reference ``SingletonOptions`` (LifeStable.hpp:93-96)."""
        return opt.is_singleton(int(self.get_options(cell)))

    def restrict_options(self, cells, options_mask):
        cells = B.to_dense(cells) if cells.dtype == jnp.uint32 else cells
        return LifeStable(P.restrict_cells(self.data, cells, options_mask))

    def set_on(self, which):
        which = B.to_dense(which) if which.dtype == jnp.uint32 else which
        return LifeStable(P.set_on(self.data, which))

    def set_off(self, which):
        which = B.to_dense(which) if which.dtype == jnp.uint32 else which
        return LifeStable(P.set_off(self.data, which))

    def set_cell_on(self, cell):
        return LifeStable(P.set_cell_on(self.data, *cell))

    def set_cell_off(self, cell):
        return LifeStable(P.set_cell_off(self.data, *cell))

    # -- lattice -----------------------------------------------------------
    def join(self, other):
        return LifeStable(P.join(self.data, other.data))

    def graft(self, other):
        return LifeStable(P.graft(self.data, other.data))

    def clear_unmodified(self):
        return LifeStable(P.clear_unmodified(self.data))

    def differences(self, other):
        return B.from_dense(P.differences(self.data, other.data))

    def compatible_with(self, other):
        if isinstance(other, LifeStable):
            return P.compatible_with(self.data, other.data)
        return P.compatible_with_state(self.data, other)

    def moved(self, dx, dy):
        d = self.data
        roll = lambda a: jnp.roll(a, (dx % 64, dy % 64), axis=(-2, -1))
        return LifeStable(P.Stable(roll(d.state), roll(d.unknown), roll(d.ruled)))

    def transformed(self, t):
        from ..symmetry import transforms as TR

        d = self.data
        f = lambda a: TR.transform_dense(a, t)
        return LifeStable(P.Stable(f(d.state), f(d.unknown), f(d.ruled)))

    # -- propagation -------------------------------------------------------
    def propagate(self):
        res = P.propagate(self.data)
        return LifeStable(res.stable), res.consistent, res.changed

    def propagate_simple(self):
        res = P.propagate_simple(self.data)
        return LifeStable(res.stable), res.consistent, res.changed

    def stabilise_options(self):
        res = P.stabilise_options(self.data)
        return LifeStable(res.stable), res.consistent, res.changed

    def perturbed_unknowns(self):
        return B.from_dense(P.perturbed_unknowns(self.data))

    def vulnerable(self):
        return B.from_dense(P.vulnerable(self.data))

    def propagate_and_test(self, max_cells=16):
        """Reference ``PropagateAndTest`` (LifeStable.hpp:163-184)."""
        res = P.propagate_and_test(self.data, max_cells=max_cells)
        return LifeStable(res.stable), res.consistent, res.changed

    def test_unknowns(self, cells):
        cells = B.to_dense(cells) if cells.dtype == jnp.uint32 else cells
        res = P.test_cells(self.data, cells)
        return LifeStable(res.stable), res.consistent, res.changed

    # -- search ------------------------------------------------------------
    def complete_stable(self, timeout=1.0, minimise=False, use_seed=False,
                        seed=None):
        """Single-board host DFS (reference CompleteStable contract)."""
        d = self.data
        assert d.state.ndim == 2, "use complete_stable_beam for batches"
        hst = HO.HostStable(
            np.asarray(d.state), np.asarray(d.unknown), np.asarray(d.ruled)
        )
        seed_np = None if seed is None else np.asarray(B.to_dense(seed))
        result, best = C.complete_stable(
            hst, timeout=timeout, minimise=minimise, use_seed=use_seed,
            seed=seed_np,
        )
        return result, B.from_dense(jnp.asarray(best))

    def complete_stable_beam(self, frontier=8, iters=192, minimise=True,
                             seed=None):
        """Batched beam completion; data must have a leading batch.
        ``seed`` (packed) enables reference useSeed proximity branching."""
        return C.complete_stable_beam(
            self.data, frontier=frontier, iters=iters, minimise=minimise,
            seed=seed,
        )

    def complete_stable_portfolio(self, key, replicas=256, frontier=4,
                                  iters=192, minimise=True):
        """Single hard instance -> orbit-randomized beam replica portfolio
        (stable/complete.complete_stable_portfolio)."""
        d = self.data
        assert d.state.ndim == 2, "portfolio searches ONE instance"
        from ..core import board as BRD

        return C.complete_stable_portfolio(
            BRD.from_dense(d.state), BRD.from_dense(d.unknown), key,
            replicas=replicas, frontier=frontier, iters=iters,
            minimise=minimise,
        )

    # -- I/O ---------------------------------------------------------------
    def rle(self):
        return P.to_rle(self.data)

    def rle_with_header(self):
        return P.to_rle_with_header(self.data)

    def sanity_check(self):
        from ..utils import debug

        debug.assert_stable_invariants(self.data)
