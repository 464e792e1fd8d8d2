"""The route decision (lifeapi_tpu.platform) and the compile-cache helper
(lifeapi_tpu.utils.compile_cache)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lifeapi_tpu import platform
from lifeapi_tpu.core import board
from lifeapi_tpu.core import convolve as CV
from lifeapi_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_cpu_picks_xla():
    assert jax.default_backend() == "cpu"
    assert not platform.has_cuda_kernels()
    assert platform.step_engine() == platform.XLA
    assert platform.step_engine(None) == "xla"


def test_explicit_xla_engine_is_kept():
    assert platform.step_engine("xla") == "xla"


@pytest.mark.parametrize("engine", ["fused", "pallas", "jnp", ""])
def test_unknown_engine_raises(engine):
    with pytest.raises(ValueError, match="expected one of"):
        platform.step_engine(engine)


def test_cuda_engine_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        platform.step_engine("cuda")


def test_conv_default_method_matches_brute_force(rng):
    """The platform's default dense transform gives exact counts."""
    assert platform.CONV_METHOD == "fft"
    da = rng.random((2, 64, 64)) < 0.3
    db = rng.random((2, 64, 64)) < 0.3
    got = np.asarray(CV.convolve_counts(board.from_dense(jnp.asarray(da)),
                                        board.from_dense(jnp.asarray(db))))
    for i in range(2):
        exp = np.zeros((64, 64), np.int64)
        for x, y in zip(*np.nonzero(da[i])):
            exp += np.roll(np.roll(db[i], x, axis=0), y, axis=1)
        assert (got[i] == exp).all()


def test_compile_cache_env_wins():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where"}
    assert compile_cache.cache_dir(env) == "/some/where"


def test_compile_cache_fixed_path_in_checkout():
    path = Path(compile_cache.cache_dir({}))
    assert path == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_enable_sets_jax_config(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
