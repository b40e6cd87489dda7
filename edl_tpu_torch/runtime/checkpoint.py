"""Asynchronous checkpoints of a `TrainState`: the port of
`edl_tpu.runtime.checkpoint`'s ``Checkpointer``.

The JAX package wraps orbax. The port writes its own format, one directory
a step under the checkpoint root:

    <root>/<step>/state.pt     torch.save of {"step", "module", "optimizer"}:
                               the module's and the optimizer's state_dicts
                               (Adam's moments and step counts, adagrad's
                               ``sum_of_squares``), every tensor on the CPU
    <root>/<step>/extra.json   the caller's ``extra`` dict, when given

It is not orbax's format and neither package reads the other's
checkpoints; carrying JAX params across is `models.convert`'s job.

- ``save`` snapshots before it returns. The port's params and moments are
  updated in place by the next ``opt.step()``, unlike JAX's immutable
  arrays, so a writer that read the live tensors later would save a mix of
  two steps. ``save`` clones every tensor (on its own device, ordered on
  the current stream) and hands only the copy to the host and the file
  write to a background thread. One save is in flight at a time: a second
  ``save`` waits for the first, as orbax's manager does.
- Each step is written to a temporary directory and renamed into place, so
  a reader sees a whole step or none. A pod can still die mid-copy on a
  shared file system, so ``restore(step=None)`` falls back from an
  unreadable newest step to the one before it; an explicit ``step``
  propagates the error.
- ``keep`` newest steps are kept; older ones are pruned after each write.

On a mesh (``Checkpointer(..., trainer=mesh_trainer)``) a step is still
one directory of whole tensors, the format above: ``save`` gathers every
rank's table rows and ZeRO-1 moment shards (`Trainer.full_state`, a
collective that every rank calls at the same step), and rank 0 writes. A
mesh of one rank and no process group (`parallel.mesh.local_mesh`) holds
every tensor whole, so its ``save`` takes the one-device path: a clone on
the device, the host copy on the writer's thread.
``restore`` reads the whole state on every rank, and each keeps its
shards (`Trainer.load_full_state`): at the same world size bit for bit,
at another one through the same code (the elastic workers' rescale,
`runtime.elastic` and `runtime.multihost`). The JAX module's mesh helpers
(``live_state_specs``, ``abstract_like``, ``state_shardings``) have no
counterpart here.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from edl_tpu_torch.runtime.train_loop import TrainState

log = logging.getLogger("edl_tpu_torch.runtime.checkpoint")

STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj: Any) -> Any:
    """``obj`` (a nest of dicts, lists and tuples) with ``fn`` applied to
    every tensor in it."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


class Checkpointer:
    """Checkpoints of one run under one directory."""

    def __init__(self, directory: str, keep: int = 3, trainer: Optional[Any] = None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        #: the mesh Trainer whose states this saves (None: one device)
        self.trainer = trainer if getattr(trainer, "mesh", None) is not None else None
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        #: the writer's failure, handed over through the join: the writer
        #: appends to the list it was given, and ``wait`` reads it only
        #: after joining, so no attribute is shared between the threads
        self._errors: List[BaseException] = []
        #: seconds from the last completed ``save`` call to its step on disk
        self.durable_seconds: Optional[float] = None

    # -- saving ----------------------------------------------------------------

    def save(self, step: int, state: TrainState, extra: Optional[dict] = None) -> None:
        """Snapshot ``state`` and write it in the background as ``step``. On
        a mesh every rank must call it: the gather is collective, and rank 0
        writes."""
        self.wait()
        t0 = time.perf_counter()
        if self.trainer is not None and self.trainer.mesh.distributed:
            snap = self.trainer.full_state(state)  # host copies of their own
            if self.trainer.mesh.rank != 0:
                return
            extra = None if extra is None else json.loads(json.dumps(extra))
            self._errors = []
            self._thread = threading.Thread(
                target=self._write,
                args=(int(step), snap, extra, None, t0, self._errors),
                name="edl-checkpoint", daemon=True)
            self._thread.start()
            return
        # a copy of every tensor, detached from the live state, on its device
        snap = _map_tensors(lambda t: t.detach().clone(), {
            "step": int(state.step), "module": state.params.state_dict(),
            "optimizer": state.opt_state.state_dict()})
        ready = None
        device = next(state.params.parameters()).device
        if device.type == "cuda":
            # the clones are queued on the current stream; the writer's copy
            # to the host waits for them on a stream of its own, beside the
            # next steps' kernels
            ready = (device, torch.cuda.Event())
            ready[1].record(torch.cuda.current_stream(device))
        extra = None if extra is None else json.loads(json.dumps(extra))
        self._errors = []
        self._thread = threading.Thread(
            target=self._write,
            args=(int(step), snap, extra, ready, t0, self._errors),
            name="edl-checkpoint", daemon=True)
        self._thread.start()

    def _write(self, step: int, snap: dict, extra: Optional[dict], ready,
               t0: float, errors: List[BaseException]) -> None:
        try:
            to_host = functools.partial(_map_tensors, lambda t: t.to("cpu"))
            if ready is None:
                host = to_host(snap)
            else:
                device, event = ready
                stream = torch.cuda.Stream(device)
                stream.wait_event(event)
                with torch.cuda.stream(stream):
                    host = to_host(snap)  # synchronous: the copy has landed
            del snap
            final = self._step_dir(step)
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(host, os.path.join(tmp, STATE_FILE))
            if extra is not None:
                with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
                    json.dump(extra, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self.durable_seconds = time.perf_counter() - t0
            self._prune()
        except BaseException as e:  # edl: noqa[EDL005] kept and re-raised by wait()/save() on the caller's thread
            errors.append(e)

    def _prune(self) -> None:
        for step in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def wait(self) -> None:
        """Block until the save in flight is on disk; re-raise its error."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def saving(self) -> bool:
        """True while a save is still in flight (non-blocking)."""
        t = self._thread
        return t is not None and t.is_alive()

    # -- reading ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """Steps on disk, oldest first (temporary directories excluded)."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int, state: TrainState) -> TrainState:
        module, opt = state.params, state.opt_state
        # read onto the host: load_state_dict copies params into the module
        # where it lives, and the optimizer moves each moment to its param's
        # device while step counts stay where torch.optim keeps them
        saved = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        if self.trainer is not None:
            return self.trainer.load_full_state(state, saved)
        module.load_state_dict(saved["module"])
        opt.load_state_dict(saved["optimizer"])
        return TrainState(int(saved["step"]), module, opt)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a step into ``state``'s module and optimizer, on the device
        the module lives on; returns the state with the saved step count. On
        a mesh each rank reads the step and keeps its shards.

        With ``step=None`` an unreadable newest step (a torn write) falls
        back to the one before it; an explicit ``step`` raises."""
        if step is not None:
            return self._load(step, state)
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        for i, candidate in enumerate(steps):
            try:
                return self._load(candidate, state)
            except Exception as e:  # edl: noqa[EDL005] a torn step surfaces as many exception types; anything unreadable demotes to the previous step
                if i == len(steps) - 1:
                    raise
                log.warning("checkpoint step %s is unreadable (%s); falling back to "
                            "previous step %s", candidate, e, steps[i + 1])
        raise AssertionError("unreachable")  # pragma: no cover

    def restore_extra(self, step: Optional[int] = None) -> Optional[Dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        try:
            with open(os.path.join(self._step_dir(step), EXTRA_FILE)) as f:
                return json.load(f)
        except Exception as e:  # edl: noqa[EDL005] logged: the caller falls back to defaults, visibly
            log.warning("restore_extra at step %s failed; continuing without extra "
                        "metadata: %s", step, e)
            return None

    def close(self) -> None:
        self.wait()


__all__ = ["Checkpointer"]
