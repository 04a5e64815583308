"""Checkpoint / resume helpers.

Counterpart of ``horovod_tpu/api/checkpoint.py``, with ``torch.save``
through the durable commit protocol (``core/durable.py``) in place of
orbax.  The reference has no general checkpoint subsystem; its idioms
are rank 0 writing a checkpoint and ``broadcast_object`` fanning a
rank-0 restore out.  This module keeps those conventions::

    ckpt = hvd.Checkpointer(dir)          # rank 0 writes, async
    ckpt.save(step, {"model": model.state_dict(),
                     "optimizer": opt.state_dict()})
    state = ckpt.restore()                 # newest step, on hvd.device()

Layout: ``<dir>/step_{step:012d}/state.pt`` beside a ``MANIFEST.json``
holding its sha256 and size (the same manifest the reference writes),
staged in ``step_N.tmp`` and promoted by rename, an older copy rotated
aside to ``step_N.old`` first.

``save`` snapshots the payload on the caller's thread: every tensor is
copied to host memory there (a copy even of a CPU tensor), before the
next step's in-place update can change it; ``torch.save``, the write
and the fsyncs run on a worker thread.  No CUDA storage goes into the
file, so a restore lands where ``map_location`` says, never on the
saver's device index.  One save is in flight at a time, and pending
saves are joined at interpreter exit.
"""

from __future__ import annotations

import atexit
import hashlib
import io
import json
import os
import re
import shutil
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional

import torch

from ..core import durable as core_durable
from ..core import state as core_state

STATE_FILE = "state.pt"


def _is_coordinator() -> bool:
    # require_init: before init() every process would default to rank 0
    # and N ranks would race writes into the same checkpoint dir
    return core_state.require_init("checkpointing").rank == 0


def to_host(tree: Any, copy: bool = True) -> Any:
    """``tree`` with every tensor in host memory (dicts, lists and tuples
    walked; other leaves as they are).  ``copy`` copies a host tensor
    too; without it a host tensor is taken as it is (the caller owns a
    private snapshot)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=copy)
    if isinstance(tree, dict):
        return type(tree)((k, to_host(v, copy)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_host(v, copy) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v, copy) for v in tree)
    return tree


def dumps(payload: Any) -> bytes:
    """``torch.save`` of ``payload`` (host tensors) into bytes."""
    buf = io.BytesIO()
    torch.save(payload, buf)
    return buf.getvalue()


def loads(data: bytes, device=None) -> Any:
    """Inverse of :func:`dumps`, tensors onto ``device`` (default: the
    state's device)."""
    if device is None:
        device = core_state.global_state().device or "cpu"
    return torch.load(io.BytesIO(data), map_location=device,
                      weights_only=False)


# One module-level exit hook over a weak set: per-instance
# atexit.register would pin every Checkpointer for process lifetime.
_live_checkpointers: "weakref.WeakSet[Checkpointer]" = weakref.WeakSet()


@atexit.register
def _flush_pending_saves_at_exit():
    for ckpt in list(_live_checkpointers):
        try:
            ckpt.wait()
        except Exception as e:  # can't raise during interpreter exit
            print(f"hvtpu.Checkpointer: {e}", file=sys.stderr)


def step_dir_name(step: int) -> str:
    return f"step_{step:012d}"


def list_steps(directory: str, require_file: Optional[str] = None
               ) -> List[int]:
    """Sorted step numbers under ``directory``; ``require_file`` keeps
    only steps whose dir contains that file."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        if require_file and not os.path.exists(
                os.path.join(directory, name, require_file)):
            continue
        out.append(int(m.group(1)))
    return sorted(out)


class Checkpointer:
    """Async, rank-0-writes checkpointing through the durable protocol.

    ``save`` returns once the payload is on the host; ``wait`` blocks
    until the last save is durable.  ``restore`` loads the newest (or a
    given) step onto ``device`` (default: the state's device).
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 use_orbax: Optional[bool] = None):
        if use_orbax:
            raise ValueError("Checkpointer: orbax is the JAX package's "
                             "format; the port writes torch.save files")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        _live_checkpointers.add(self)
        if _is_coordinator():
            os.makedirs(self.directory, exist_ok=True)

    # -- write side ----------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, step_dir_name(step))

    def save(self, step: int, payload: Dict[str, Any]):
        """Queue an async save of ``payload`` at ``step`` (rank 0 only;
        other ranks no-op, like the reference's rank-0 convention)."""
        if not _is_coordinator():
            return
        self.wait()  # one in flight at a time
        host = to_host(payload)

        def _write():
            try:
                target = self._step_dir(step)
                # Stage into a FRESH .tmp: a leftover from a killed
                # writer would otherwise leak stale files into the
                # final checkpoint.
                tmp = target + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                raw = dumps(host)
                core_durable.atomic_write(
                    os.path.join(tmp, STATE_FILE), raw,
                    detail=f"{STATE_FILE}@{step_dir_name(step)}")
                core_durable.atomic_write(
                    os.path.join(tmp, core_durable.MANIFEST),
                    json.dumps({
                        "files": {STATE_FILE: {
                            "sha256": hashlib.sha256(raw).hexdigest(),
                            "bytes": len(raw),
                        }}}, sort_keys=True).encode(),
                    detail=f"manifest@{step_dir_name(step)}")
                # Overwrite without a lose-both window: rotate the old
                # step aside, promote the staged one, then drop the
                # rotated copy — a crash at any point leaves a loadable
                # step_N or step_N.old.
                if os.path.exists(target):
                    old = target + ".old"
                    shutil.rmtree(old, ignore_errors=True)
                    os.replace(target, old)
                    os.replace(tmp, target)
                    shutil.rmtree(old, ignore_errors=True)
                else:
                    os.replace(tmp, target)
                self._gc()
            except BaseException as e:  # surfaced at wait()/next save
                self._error = e

        self._pending = threading.Thread(target=_write, daemon=True)
        self._pending.start()

    def wait(self):
        """Block until the last queued save is durable; re-raises any
        failure of the writer."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _gc(self):
        if not self.max_to_keep:
            return
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- read side -----------------------------------------------------
    def all_steps(self) -> List[int]:
        return list_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @staticmethod
    def _verified(target: str) -> bool:
        """Manifest verification of one step dir; a step without a
        manifest passes (there is nothing recorded to check)."""
        if not os.path.exists(os.path.join(target, core_durable.MANIFEST)):
            return True
        return core_durable.verify_snapshot(target)

    def restore(self, step: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None, device=None
                ) -> Optional[Dict[str, Any]]:
        """Load ``step`` (default: newest) onto ``device``; None when no
        checkpoint.  ``template`` is accepted and dropped: the file
        carries its own types and shapes.  A step failing manifest verification raises when
        it was requested explicitly and falls back to the newest
        earlier intact step otherwise."""
        explicit = step is not None
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        target = self._step_dir(step)
        if not os.path.isdir(target) and os.path.isdir(target + ".old"):
            # a save died between rotating the old step aside and
            # promoting the staged one: put the rotated copy back
            os.replace(target + ".old", target)
        if not os.path.isdir(target):
            raise FileNotFoundError(
                f"no checkpoint at step {step} under "
                f"{self.directory!r}: neither {step_dir_name(step)} "
                "nor its .old recovery copy exists")
        if not self._verified(target):
            if explicit:
                raise ValueError(
                    f"checkpoint step {step} under {self.directory!r} "
                    "fails manifest verification (torn or corrupt)")
            for s in reversed(self.all_steps()):
                if s >= step:
                    continue
                if self._verified(self._step_dir(s)):
                    print(f"hvtpu.Checkpointer: step {step} fails "
                          f"manifest verification; falling back to "
                          f"step {s}", file=sys.stderr)
                    target = self._step_dir(s)
                    break
            else:
                raise ValueError(
                    f"every checkpoint under {self.directory!r} fails "
                    "manifest verification")
        with open(os.path.join(target, STATE_FILE), "rb") as f:
            return loads(f.read(), device)


def save_checkpoint(directory: str, step: int, payload: Dict[str, Any],
                    max_to_keep: Optional[int] = None) -> Checkpointer:
    """One-shot convenience: async rank-0 save (returns the
    Checkpointer so callers can ``wait()``)."""
    ckpt = Checkpointer(directory, max_to_keep=max_to_keep)
    ckpt.save(step, payload)
    return ckpt


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       template: Optional[Dict[str, Any]] = None,
                       broadcast: bool = True, device=None):
    """Restore on rank 0 and (by default) fan out to every rank with
    ``broadcast_object``; tensors land on ``device`` (default: the
    state's device) on every rank.  ``template`` is dropped, as in
    :meth:`Checkpointer.restore`."""
    from ..torch import functions

    st = core_state.require_init("restore_checkpoint")
    device = st.device if device is None else device
    payload = None
    if st.rank == 0:
        payload = Checkpointer(directory).restore(step, template,
                                                  device="cpu")
    if broadcast and st.size > 1:
        payload = functions.broadcast_object(payload, root_rank=0)
    if payload is None:
        return None
    return to_device(payload, device)


def to_device(tree: Any, device) -> Any:
    """``tree`` with every tensor moved onto ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return type(tree)((k, to_device(v, device)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree
