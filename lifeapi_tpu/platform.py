"""The one place that decides which route runs on this backend.

Two engines do the library's stepping work:

* ``"cuda"`` — the hand-written fused rollout kernels (ops/step_cuda),
  compiled for NVIDIA GPUs; they have no CPU or interpreter form.
* ``"xla"`` — the plain jnp code (core.step and its callers), which XLA
  compiles for any backend and which the tests use as the reference.

``engine=None`` everywhere means "the platform's choice": the kernels on
a GPU, XLA elsewhere.  Asking for ``"cuda"`` on a backend that cannot run
it raises; nothing falls back or interprets silently.
"""

from __future__ import annotations

import jax

CUDA = "cuda"
XLA = "xla"
ENGINES = (CUDA, XLA)


def has_cuda_kernels():
    """True when the default backend is a GPU that runs the CUDA kernels."""
    return jax.default_backend() == "gpu"


def step_engine(engine=None):
    """Resolve an ``engine=`` argument of the stepping paths (rollout,
    catalyst search, MPC hard scoring) to ``"cuda"`` or ``"xla"``."""
    if engine is None:
        return CUDA if has_cuda_kernels() else XLA
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}; expected one of {ENGINES}")
    if engine == CUDA and not has_cuda_kernels():
        raise RuntimeError(
            f"engine='cuda' needs an NVIDIA GPU backend, but this process "
            f"runs on {jax.default_backend()!r}; use engine='xla' or None")
    return engine


# Default transform of the dense convolution paths (core.convolve): the
# complex float32 FFT on every backend.  On the H100 it beat the two-prime
# bf16 NTT 2x at 4,096 board pairs (PERF.md).
CONV_METHOD = "fft"
