#!/usr/bin/env python
"""Example: still-life completion — reconstruct an eater from partial
information (the reference's CompleteStable workflow)."""

import numpy as np

from lifeapi_tpu.core import board, rle
from lifeapi_tpu.stable import complete, host
from lifeapi_tpu.utils import compile_cache


def main():
    eater = np.asarray(board.to_dense(board.move(rle.parse("2b2o$bobo$bo$2o!"), 20, 20)))
    hide = np.zeros((64, 64), bool)
    hide[20:22, 20] = True  # forget two cells
    st = host.HostStable(eater & ~hide, hide)
    result, best = complete.complete_stable(st, timeout=5.0, minimise=True)
    print(result)
    print(rle.write_rle(best))


if __name__ == "__main__":
    compile_cache.enable()
    main()
