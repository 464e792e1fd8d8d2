"""chip_smoke.py's phases at tiny sizes on the CPU: the plumbing, the
independent references and the comparisons, without the card."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402


def test_main_refuses_without_gpu(capsys):
    assert CS.main([]) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_phase_rollout_tiny():
    step = CS.Step()
    detail = CS.phase_rollout(step, n_boards=16, steps=8)
    assert detail["boards"] == 16
    assert step.compile_s > 0 and step.run_s > 0
    assert step.memory["output_size_in_bytes"] == 16 * 64 * 2 * 4


def test_phase_catalyst_tiny():
    detail = CS.phase_catalyst(CS.Step(), horizon=16, max_offsets=32)
    assert detail["placements"] == 32


def test_phase_mpc_tiny():
    detail = CS.phase_mpc(CS.Step(), horizon=3, n_candidates=2, iters=2)
    assert detail["candidates"] == 2


def test_phase_stable_tiny():
    detail = CS.phase_stable(CS.Step(), chunk=8, n_chunks=2, iters=8,
                             check_chunks=(0, 1), dfs_samples=4)
    assert detail["problems"] == 16 and detail["dfs_checked"] == 4
    assert detail["found"] > 0


def test_phase_conv_tiny():
    detail = CS.phase_conv(CS.Step(), n_pairs=6, brute_pairs=2)
    assert detail["pairs"] == 6 and detail["dense_max_count"] > 48


def test_numpy_references_agree(rng):
    """The numpy FFT count equals the brute-force count, and the numpy
    interaction offsets equal the library's on a glider/eater pair."""
    import jax.numpy as jnp

    from lifeapi_tpu.core import board, rle
    from lifeapi_tpu.core import convolve as CV

    da = rng.random((64, 64)) < 0.2
    db = rng.random((64, 64)) < 0.05
    assert (CS._np_counts_fft(da, db) == CS._np_counts_brute(da, db)).all()
    glider = board.move(rle.parse("bob$2bo$3o!"), 8, 8)
    eater = board.move(rle.parse("2b2o$bobo$bo$2o!"), 24, 24)
    got = np.asarray(board.to_dense(CV.interaction_offsets(glider, eater)))
    ref = CS._np_interaction(np.asarray(board.to_dense(glider)),
                             np.asarray(board.to_dense(eater)))
    assert (got == ref).all()
    with pytest.raises(AssertionError, match="entries differ"):
        CS._equal(jnp.zeros(3), jnp.ones(3), "x")


def test_run_phase_line(capsys):
    CS._run_phase(1, "rollout",
                  lambda s: CS.phase_rollout(s, n_boards=4, steps=2))
    line = capsys.readouterr().out.strip()
    assert line.startswith("phase 1 rollout: ok wall=")
    assert "compile=" in line and "memory_analysis=" in line


def test_phase_four_tiny():
    """The --four phase on four of the eight virtual CPU devices."""
    detail = CS.phase_four(CS.Step(), n_boards=16, steps=4, horizon=8,
                           n_problems=16, beam_iters=4, replicas=16,
                           portfolio_iters=8, candidates=4, mpc_horizon=3,
                           mpc_iters=2)
    assert set(detail) == {"rollout", "catalyst", "beam_two_phase_False",
                           "beam_two_phase_True", "portfolio",
                           "scenario_sweep"}
