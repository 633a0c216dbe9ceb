"""Checkpoint save and restore in a torch-native format.

Counterpart of ``itsd_tpu/train/checkpoint.py`` (Orbax there). A full
checkpoint is one ``torch.save`` file holding a dict with the step, the
model's state dict (``params``), the optimizer's and the schedule's state
dicts (``opt_state``, ``lr_schedule``) and the EMA state dict
(``ema_params``, None without EMA), so training truly resumes. A
weights-only checkpoint (``save_params``) is a bare state dict. Both hold
CPU tensors. Orbax checkpoints of the JAX package cannot be read here.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from .loop import TrainState

FULL_KEYS = ("step", "params", "opt_state", "lr_schedule", "ema_params")


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def to_host(obj):
    """A copy of ``obj`` (nested dicts, lists and tuples of tensors) with
    every tensor detached and copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def state_on_host(state: TrainState) -> dict:
    """The full checkpoint's dict, copied to the host (no optimizer state
    for a state that has none, as one loaded for sampling)."""
    tx = state.tx
    return to_host({
        "step": state.step,
        "params": state.model.state_dict(),
        "opt_state": tx.optimizer.state_dict() if tx else None,
        "lr_schedule": tx.lr_schedule.state_dict() if tx else None,
        "ema_params": state.ema,
    })


def _write(path: str, obj) -> None:
    """torch.save under a temporary name, then rename: a reader never sees
    half a file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState) -> None:
    _write(_abspath(path), state_on_host(state))


def is_full_checkpoint(obj) -> bool:
    return isinstance(obj, dict) and set(FULL_KEYS) <= set(obj)


def restore_checkpoint(path: str, state: Optional[TrainState] = None):
    """Load a full checkpoint. With ``state``, load it into the state's
    model, optimizer, schedule and EMA in place and return the state;
    without, return the checkpoint's dict (CPU tensors)."""
    ckpt = torch.load(_abspath(path), map_location="cpu", weights_only=True)
    if not is_full_checkpoint(ckpt):
        raise KeyError(f"{path}: not a full training checkpoint (keys "
                       f"{FULL_KEYS} expected)")
    if state is None:
        return ckpt
    state.step = int(ckpt["step"])
    state.model.load_state_dict(ckpt["params"])
    state.tx.optimizer.load_state_dict(ckpt["opt_state"])
    state.tx.lr_schedule.load_state_dict(ckpt["lr_schedule"])
    if (state.ema is None) != (ckpt["ema_params"] is None):
        raise ValueError(f"{path}: EMA present in only one of the "
                         "checkpoint and the state")
    if state.ema is not None:
        for k, v in state.ema.items():
            v.copy_(ckpt["ema_params"][k])
    return state


class AsyncCheckpointManager:
    """Checkpoints written by one background thread while training goes on.
    ``save`` copies the state to the host before it returns (so the next
    step may update the state in place), then hands the write to the
    thread; one write is in flight at a time. An error in a write is raised
    by the next ``save``, ``wait`` or ``close``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state: TrainState) -> None:
        self.wait()
        host = state_on_host(state)
        path = _abspath(path)

        def write():
            try:
                _write(path, host)
            except BaseException as e:  # noqa: BLE001 (raised by wait)
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def save_params(path: str, params) -> None:
    """Weights-only checkpoint: a state dict, as ``evaluate`` loads."""
    _write(_abspath(path), to_host(dict(params)))


def restore_params(path: str):
    return torch.load(_abspath(path), map_location="cpu", weights_only=True)
