#!/usr/bin/env python
"""Example: batched catalyst search — find eater placements that consume a
glider and recover (the classic LifeAPI-style search, batched on the
device)."""

import numpy as np
import jax.numpy as jnp

from lifeapi_tpu import search
from lifeapi_tpu.core import board, rle
from lifeapi_tpu.symmetry import transforms as tr
from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T
from lifeapi_tpu.utils import compile_cache


def main():
    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(tr.transform(rle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)

    offsets = jnp.asarray(
        [[dx, dy] for dx in range(-8, 9) for dy in range(-8, 9)], dtype=jnp.int32
    )
    result = search.catalyst_search(glider, eater, offsets, horizon=100)
    hits = np.asarray(search.successful_catalysts(result))
    print(f"{hits.sum()} working placements out of {len(offsets)}")
    for i in np.nonzero(hits)[0][:5]:
        dx, dy = np.asarray(result.offsets[i])
        print(f"  eater moved by ({dx}, {dy}) eats the glider and recovers")


if __name__ == "__main__":
    compile_cache.enable()
    main()
