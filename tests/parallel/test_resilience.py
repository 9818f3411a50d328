"""Fault-tolerant step loop: transient-failure rollback to the last
complete checkpoint, cross-process resume, retention pruning, and
fault-injection (the reference has no failure-detection subsystem;
SURVEY §5)."""

import os

import numpy as np
import pytest

from gt4py_tpu.parallel import CartesianMesh
from gt4py_tpu.utils.resilience import RunReport, is_transient_error, run_resilient


@pytest.fixture(scope="module")
def cmesh():
    import jax

    assert len(jax.devices()) == 8
    return CartesianMesh((2, 4))


def _sharded_init(cmesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(cmesh.mesh, P("x", "y", None))

    def init():
        return {"u": jax.device_put(np.zeros((8, 8, 2), np.float64), sh)}

    return init, sh


def _step(state):
    return {"u": state["u"] + 1.0}


def test_transient_classifier():
    assert is_transient_error(RuntimeError("UNAVAILABLE: device gone"))
    assert is_transient_error(RuntimeError("FAILED_PRECONDITION: readback"))
    assert not is_transient_error(RuntimeError("some real bug"))
    assert not is_transient_error(ValueError("UNAVAILABLE"))  # wrong class


def test_plain_run_and_checkpoints(tmp_path, cmesh):
    init, _ = _sharded_init(cmesh)
    state, report = run_resilient(
        _step, None, n_steps=10, directory=str(tmp_path),
        checkpoint_every=3, init_fn=init,
    )
    assert float(np.asarray(state["u"])[0, 0, 0]) == 10.0
    assert report.steps_run == 10 and report.restarts == 0
    assert report.checkpoints == 4  # steps 3, 6, 9, 10
    # retention: only the last 2 checkpoint dirs survive
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000009", "step_00000010"]


def test_transient_failure_rolls_back(tmp_path, cmesh):
    init, _ = _sharded_init(cmesh)
    boom = {"at": 7, "fired": False}

    def step(state):
        v = float(np.asarray(state["u"])[0, 0, 0])
        if v == boom["at"] and not boom["fired"]:
            boom["fired"] = True
            raise RuntimeError("UNAVAILABLE: injected chip loss")
        return _step(state)

    state, report = run_resilient(
        step, None, n_steps=10, directory=str(tmp_path),
        checkpoint_every=2, init_fn=init,
    )
    assert float(np.asarray(state["u"])[0, 0, 0]) == 10.0
    assert report.restarts == 1
    assert report.failures and "injected chip loss" in report.failures[0][1]
    # rolled back to step 6's checkpoint and replayed 7..10
    assert report.steps_run == 10 - 0 + (7 - 6)


def test_nontransient_failure_propagates(tmp_path, cmesh):
    init, _ = _sharded_init(cmesh)

    def step(state):
        raise ValueError("real bug")

    with pytest.raises(ValueError, match="real bug"):
        run_resilient(
            step, None, n_steps=3, directory=str(tmp_path),
            checkpoint_every=1, init_fn=init,
        )


def test_max_restarts_exhausted(tmp_path, cmesh):
    init, _ = _sharded_init(cmesh)

    def step(state):
        raise RuntimeError("UNAVAILABLE: always")

    with pytest.raises(RuntimeError, match="always"):
        run_resilient(
            step, None, n_steps=3, directory=str(tmp_path),
            checkpoint_every=1, init_fn=init, max_restarts=2,
        )


def test_rollback_without_durable_checkpoint_restores_state(tmp_path, cmesh):
    """A transient failure BEFORE any checkpoint rolls the STATE back with
    the step counter -- resetting only the counter would re-apply completed
    steps on top of the already-advanced state."""
    init, _ = _sharded_init(cmesh)
    boom = {"fired": False}

    def step(state):
        if float(np.asarray(state["u"])[0, 0, 0]) == 2 and not boom["fired"]:
            boom["fired"] = True
            raise RuntimeError("UNAVAILABLE: injected")
        return _step(state)

    state, report = run_resilient(
        step, None, n_steps=4, directory=str(tmp_path),
        checkpoint_every=0, init_fn=init,
    )
    assert report.restarts == 1
    assert float(np.asarray(state["u"])[0, 0, 0]) == 4.0  # not 6.0


def test_rollback_preserves_live_sharding(tmp_path, cmesh):
    """Rollback without an explicit shardings arg keeps arrays sharded as
    they were (derived from the live state), not host numpy."""
    import jax

    init, sh = _sharded_init(cmesh)
    boom = {"fired": False}

    def step(state):
        assert isinstance(state["u"], jax.Array) and state["u"].sharding == sh
        if float(np.asarray(state["u"])[0, 0, 0]) == 3 and not boom["fired"]:
            boom["fired"] = True
            raise RuntimeError("UNAVAILABLE: injected")
        return _step(state)

    state, report = run_resilient(
        step, None, n_steps=5, directory=str(tmp_path),
        checkpoint_every=2, init_fn=init,
    )
    assert report.restarts == 1
    assert state["u"].sharding == sh
    assert float(np.asarray(state["u"])[0, 0, 0]) == 5.0


def test_incomplete_checkpoint_dir_skipped_on_resume(tmp_path, cmesh):
    """Resume ignores a checkpoint directory whose manifest set is
    incomplete (multi-host crash mid-save)."""
    import glob
    import json

    init, sh = _sharded_init(cmesh)
    run_resilient(_step, None, n_steps=4, directory=str(tmp_path),
                  checkpoint_every=2, init_fn=init)
    # corrupt the LATEST checkpoint into a partial 2-process save
    latest = sorted(glob.glob(os.path.join(str(tmp_path), "step_*")))[-1]
    (mpath,) = glob.glob(os.path.join(latest, "manifest.p*.json"))
    with open(mpath) as f:
        m = json.load(f)
    m["process_count"] = 2
    with open(mpath, "w") as f:
        json.dump(m, f)
    state, report = run_resilient(
        _step, None, n_steps=6, directory=str(tmp_path),
        checkpoint_every=0, shardings={"u": sh},
    )
    assert report.resumed_from == 2  # step_4 skipped as incomplete
    assert float(np.asarray(state["u"])[0, 0, 0]) == 6.0


def test_cross_process_resume(tmp_path, cmesh):
    """A fresh invocation pointed at the same directory resumes from the
    last COMPLETE checkpoint (process-restart recovery)."""
    init, sh = _sharded_init(cmesh)
    run_resilient(
        _step, None, n_steps=6, directory=str(tmp_path),
        checkpoint_every=2, init_fn=init,
    )
    # "new process": state=None, resumes at step 6 and finishes to 9
    state, report = run_resilient(
        _step, None, n_steps=9, directory=str(tmp_path),
        checkpoint_every=2, shardings={"u": sh},
    )
    assert report.resumed_from == 6
    assert report.steps_run == 3
    assert float(np.asarray(state["u"])[0, 0, 0]) == 9.0
    assert state["u"].sharding == sh
