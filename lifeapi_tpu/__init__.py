"""lifeapi_tpu — a batched Life search & trajectory-optimization framework.

A from-scratch JAX/XLA re-design with the capabilities of
scorbiclife/LifeAPI (64x64-torus Life bitboards, pattern matching, symmetry,
still-life constraint solving) plus a batched MPC engine scaling over
device meshes; its hot rollouts are fused CUDA kernels on NVIDIA GPUs.  See SURVEY.md for the reference component inventory this
implements and README.md for the architecture map.
"""

from .core import bitops, board, convolve, rle, step, strips  # noqa: F401
from .state import LifeState  # noqa: F401
from .target import LifeTarget  # noqa: F401

__version__ = "0.1.0"
