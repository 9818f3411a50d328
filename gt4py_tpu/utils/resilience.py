"""Fault-tolerant execution: a checkpointed step loop with transient-error
recovery.

The reference has no failure-detection story (SURVEY.md §5: "None").  On
shared accelerator pools one is needed in practice: device dispatch can
fail transiently (UNAVAILABLE / FAILED_PRECONDITION from a preempted or
relocated device) and long runs must survive restarts.  This module keeps
the policy minimal and explicit:

- :func:`run_resilient` drives ``state = step_fn(state)`` for N steps,
  checkpointing every ``checkpoint_every`` steps (sharded, async);
- a step failing with a TRANSIENT error (jax runtime UNAVAILABLE /
  FAILED_PRECONDITION / DATA_LOSS, or a caller predicate) rolls state
  back to the last complete checkpoint and retries, up to
  ``max_restarts`` times;
- a fresh process pointed at the same directory resumes from the last
  complete checkpoint automatically (manifest-last crash consistency).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from gt4py_tpu.utils.checkpoint import (
    is_checkpoint_complete,
    load_checkpoint_sharded,
    save_checkpoint_sharded,
)

_TRANSIENT_MARKERS = ("UNAVAILABLE", "FAILED_PRECONDITION", "DATA_LOSS")


def is_transient_error(exc: BaseException) -> bool:
    """Default transient-error classifier: jax/XLA runtime errors whose
    message carries a retryable status code."""
    msg = str(exc)
    return isinstance(exc, RuntimeError) and any(
        m in msg for m in _TRANSIENT_MARKERS
    )


@dataclass
class RunReport:
    steps_run: int = 0
    restarts: int = 0
    resumed_from: Optional[int] = None  # step of the checkpoint resumed at start
    checkpoints: int = 0
    failures: list = field(default_factory=list)  # (step, repr(exc))


def run_resilient(
    step_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
    state: Optional[Dict[str, Any]],
    *,
    n_steps: int,
    directory: str,
    checkpoint_every: int = 0,
    shardings: Optional[Dict[str, Any]] = None,
    max_restarts: int = 3,
    is_transient: Callable[[BaseException], bool] = is_transient_error,
    init_fn: Optional[Callable[[], Dict[str, Any]]] = None,
) -> tuple:
    """Run ``state = step_fn(state)`` ``n_steps`` times with checkpointed
    recovery; returns ``(state, RunReport)``.

    ``state=None`` resumes from ``directory`` when a checkpoint exists,
    else calls ``init_fn()``.  ``shardings`` re-shards restored arrays
    (name -> jax Sharding).  Non-transient exceptions propagate after an
    immediate durability flush of nothing (the last checkpoint stays the
    recovery point).
    """
    report = RunReport()
    start_step = 0
    pending = None  # async CheckpointHandle
    keep = 2  # retained complete checkpoints (older pruned after a new one)

    def _live_shardings(st):
        """Rollback must restore arrays with their CURRENT shardings, not
        host numpy: derive them from the live state, caller overrides win."""
        try:
            import jax
        except ImportError:  # pragma: no cover
            return shardings
        derived = {
            k: v.sharding
            for k, v in (st or {}).items()
            if isinstance(v, jax.Array)
        }
        derived.update(shardings or {})
        return derived or None

    def restore(sh):
        last = _latest_checkpoint(directory)
        loaded, meta = load_checkpoint_sharded(last, shardings=sh)
        return loaded, int(meta["step"])

    if state is None:
        if _latest_checkpoint(directory) is not None:
            state, start_step = restore(shardings)
            report.resumed_from = start_step
        elif init_fn is not None:
            state = init_fn()
        else:
            raise ValueError(
                "state is None, no checkpoint to resume from and no init_fn"
            )

    # kept for durable-checkpoint-free rollback: step_fn is functional
    # (returns a fresh dict), so holding the start-of-run state is free
    initial_state = state
    step = start_step
    while step < n_steps:
        try:
            new_state = step_fn(state)
        except BaseException as exc:  # noqa: BLE001 -- classified below
            if not is_transient(exc) or report.restarts >= max_restarts:
                raise
            report.restarts += 1
            report.failures.append((step, repr(exc)))
            if pending is not None:
                pending.wait()
                pending = None
            if _latest_checkpoint(directory) is not None:
                state, step = restore(_live_shardings(state))
            else:
                # nothing durable yet: roll STATE and step back together
                # (resetting only the counter would re-apply completed
                # steps on top of the advanced state)
                state, step = initial_state, start_step
            continue
        state = new_state
        step += 1
        report.steps_run += 1
        if checkpoint_every and (step % checkpoint_every == 0 or step == n_steps):
            if pending is not None:
                pending.wait()
                _prune(directory, keep)
            # each checkpoint in its OWN subdirectory: an in-place
            # overwrite crash would corrupt the previous recovery point
            pending = save_checkpoint_sharded(
                os.path.join(directory, f"step_{step:08d}"),
                state,
                step=step,
                wait=False,
            )
            report.checkpoints += 1
    if pending is not None:
        pending.wait()
        _prune(directory, keep)
    return state, report


def _checkpoint_dirs(directory: str):
    import glob

    out = []
    for m in glob.glob(os.path.join(directory, "step_*", "manifest.p*.json")):
        d = os.path.dirname(m)
        if d not in out and is_checkpoint_complete(d):
            out.append(d)
    return sorted(out)


def _latest_checkpoint(directory: str) -> Optional[str]:
    dirs = _checkpoint_dirs(directory)
    return dirs[-1] if dirs else None


def _prune(directory: str, keep: int) -> None:
    import shutil

    for d in _checkpoint_dirs(directory)[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
