"""Fused multi-generation rollouts as hand-written CUDA kernels.

``step_kernels.cu`` holds three kernels for NVIDIA Hopper: a plain
rollout, the MPC controlled rollout (toggles XORed in before each
generation) and the catalyst-search rollout (baseline comparison in the
catalyst's zone of influence each generation).  Each keeps a board in
registers for the whole horizon: eight threads of a warp own one board,
each holding eight adjacent columns, and the neighbour columns move by
warp shuffle.  All are bit-exact with :func:`lifeapi_tpu.core.step.step`.

The shared library is built from the source with ``nvcc`` on first use
(into ``_build/`` next to this file, rebuilt when the source is newer)
and its handlers are registered with XLA through ``jax.ffi``.  Nothing
here runs without a CUDA GPU; :mod:`lifeapi_tpu.platform` decides when
these kernels are used, and the XLA path (``core.step``) is the
reference they are tested against.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitops

_HERE = Path(__file__).parent
_SRC = _HERE / "step_kernels.cu"
_BUILD = _HERE / "_build"
_LIB = _BUILD / "libstep_kernels.so"

_TARGETS = {
    "LifeRollout": "lifeapi_rollout",
    "LifeControlledRollout": "lifeapi_controlled_rollout",
    "LifeCatalystRollout": "lifeapi_catalyst_rollout",
}
_registered = False


def _nvcc():
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: set NVCC or put the CUDA toolkit's "
                       "bin directory on PATH to build the step kernels")


def build():
    """Compile step_kernels.cu into _build/ unless the library is current;
    returns the library path.  sm_90a code for Hopper plus compute_80
    PTX, so other cards from Ampere on can JIT it."""
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    _BUILD.mkdir(exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-gencode", "arch=compute_90a,code=sm_90a",
         "-gencode", "arch=compute_80,code=compute_80",
         "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:  # the XLA headers warn a lot; show only errors
        raise RuntimeError(f"nvcc failed building {_SRC.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB)  # atomic: concurrent builders never see half a file
    return _LIB


def _register():
    global _registered
    if not _registered:
        lib = ctypes.cdll.LoadLibrary(str(build()))
        for symbol, name in _TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, symbol)),
                platform="CUDA")
        _registered = True


def to_eo(boards):
    """packed uint32[..., 64, 2] (lo, hi) -> the kernels' even/odd
    packing, same shape (core/bitops.interleave_split per column)."""
    e, o = bitops.interleave_split(boards[..., 0], boards[..., 1])
    return jnp.stack([e, o], axis=-1)


def from_eo(eo):
    """Inverse of :func:`to_eo`."""
    lo, hi = bitops.interleave_merge(eo[..., 0], eo[..., 1])
    return jnp.stack([lo, hi], axis=-1)


def rollout(boards, steps):
    """packed uint32[..., 64, 2] -> the boards after ``steps`` generations."""
    _register()
    shape = boards.shape
    eo = to_eo(boards.reshape(-1, 64, 2))
    out = jax.ffi.ffi_call(
        "lifeapi_rollout", jax.ShapeDtypeStruct(eo.shape, jnp.uint32)
    )(eo, steps=np.int64(steps))
    return from_eo(out).reshape(shape)


def controlled_rollout(boards, toggles):
    """boards uint32[B, 64, 2], toggles uint32[T, B, 64, 2] -> the boards
    after T generations of XOR-toggle-then-step (mpc.soft.hard_rollout)."""
    _register()
    return from_eo(jax.ffi.ffi_call(
        "lifeapi_controlled_rollout",
        jax.ShapeDtypeStruct(boards.shape, jnp.uint32),
    )(to_eo(boards), to_eo(toggles)))


def catalyst_rollout(boards, active, placed, placed_zoi, steps):
    """Catalyst-search rollout (search.catalyst_search): boards, placed and
    placed_zoi uint32[P, 64, 2]; active uint32[64, 2], the reaction
    without catalyst, stepped beside every board.  Returns (final boards,
    interacted bool[P], baseline after ``steps`` generations): a
    placement interacted iff after some generation its board differs
    from (baseline | placed) inside placed_zoi."""
    _register()
    n = boards.shape[0]
    final, hit, base_final = jax.ffi.ffi_call(
        "lifeapi_catalyst_rollout",
        (jax.ShapeDtypeStruct(boards.shape, jnp.uint32),
         jax.ShapeDtypeStruct((n,), jnp.uint32),
         jax.ShapeDtypeStruct((64, 2), jnp.uint32)),
    )(to_eo(boards), to_eo(active), to_eo(placed), to_eo(placed_zoi),
      steps=np.int64(steps))
    return from_eo(final), hit != 0, from_eo(base_final)
