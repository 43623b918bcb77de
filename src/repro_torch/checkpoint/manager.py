"""Checkpoint manager: async saves, keep-N retention, auto-resume (the
port of the reference's `checkpoint/manager.py`).

Across a mesh (`CheckpointManager(root, mesh=)`, one per rank): a save
gathers each leaf whole from the ranks' blocks (`specs`: {leaf name:
partition spec}, as `bridge.train_state_specs` gives them) onto the
mesh's first rank, which writes the layout of an unmeshed save; every
rank learns at `wait()` that the step is committed (or that the write
failed). A restore cuts each rank's block out of the whole leaves for
the mesh the job has, which need not be the mesh that saved (the
reference's `restore(..., shardings=)`).

Failure model handled:
  * process crash mid-save        -> COMMIT protocol: partial dirs are
                                      ignored and garbage-collected;
  * straggler checkpoint writes   -> saves run on a background thread
                                      after a synchronous snapshot to
                                      host memory; the train loop never
                                      blocks on IO (`wait()` only at the
                                      next save or at shutdown), and a
                                      failed write raises at `wait()`;
  * data-pipeline recovery        -> the manager persists the step, and
                                      `repro_torch.data` batches are pure
                                      functions of (seed, shard, step).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint.ckpt import (
    is_committed, restore_pytree, save_pytree,
)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.tree import leaves_with_path, path_name, tree_map, \
    tree_unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")


def is_first_rank(mesh) -> bool:
    """Whether this rank sits at the mesh's coordinate (0, ..., 0)."""
    return not any(mesh_mod.mesh_coordinate(mesh).values())


def host_snapshot(tree: Any, mesh=None,
                  specs: Optional[Dict[str, Any]] = None) -> Any:
    """A copy of every tensor leaf in host memory (one synchronize, then
    blocking device-to-host copies): later updates of `tree` do not
    reach it. With `mesh`: each leaf gathered whole from the ranks'
    blocks under its spec in `specs` (a leaf not named is whole), one
    leaf at a time, and copied on the mesh's first rank alone; the
    other ranks get None."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if mesh is None:
        return tree_map(lambda x: x.detach().to("cpu", copy=True)
                        if isinstance(x, torch.Tensor) else x, tree)
    first = is_first_rank(mesh)
    out = []
    for path, leaf in leaves_with_path(tree):
        whole = mesh_mod.gather_whole(
            leaf.detach(), (specs or {}).get(path_name(path), ()), mesh)
        out.append(whole.to("cpu", copy=True) if first else None)
        del whole
    return tree_unflatten(tree, out) if first else None


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, mesh=None):
        self.root = root
        self.keep = keep
        #: the mesh whose ranks each hold a manager (None: one process)
        self.mesh = mesh
        #: whether this process writes and collects garbage: the mesh's
        #: first rank
        self.writer = mesh is None or is_first_rank(mesh)
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False
        if self.writer:
            self.gc_uncommitted()

    # ------------------------------------------------------------------ #
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            if m and is_committed(os.path.join(self.root, d)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             specs: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot to host memory synchronously, write async. Across a
        mesh every rank calls it; `specs` names each leaf's partition
        spec (`host_snapshot`)."""
        self.wait()                       # one in-flight save at a time
        host_tree = host_snapshot(tree, self.mesh, specs)
        target = self._dir(step)
        self._pending = True

        def _write():
            try:
                save_pytree(host_tree, target)
                self._gc()
            except BaseException as e:     # surfaced on next wait()
                self._error = e

        if self.writer:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Until the save in flight is committed; raises its write's
        error (across a mesh, on every rank: the ranks agree on it, so
        each returns only once the step is committed)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None and self._pending:
            failed = torch.tensor([float(self._error is not None)],
                                  device=mesh_mod.mesh_device(self.mesh))
            for axis in mesh_mod.AXES:
                mesh_mod.all_reduce_sum(failed, self.mesh, axis)
            if failed.item() and self._error is None:
                self._error = RuntimeError(
                    "the checkpoint write failed on the mesh's first rank")
        self._pending = False
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------ #
    def restore(self, target: Any, *, step: Optional[int] = None,
                device=None, specs: Optional[Dict[str, Any]] = None) -> Any:
        """The checkpoint of `step` (default: the latest committed one)
        in `target`'s structure, on `device` (default: the CUDA card);
        across the manager's mesh, this rank's blocks under `specs`
        (`ckpt.restore_pytree`), whatever mesh saved it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under "
                                    f"{self.root}")
        return restore_pytree(target, self._dir(step), device=device,
                              mesh=self.mesh, specs=specs)

    def restore_or_init(self, target: Any, init_fn, *, device=None,
                        specs: Optional[Dict[str, Any]] = None):
        """Auto-resume: restore the latest committed step or initialize.
        Returns (tree, start_step)."""
        step = self.latest_step()
        if step is None:
            return init_fn(), 0
        return self.restore(target, step=step, device=device,
                            specs=specs), step

    # ------------------------------------------------------------------ #
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def gc_uncommitted(self) -> None:
        for d in os.listdir(self.root):
            full = os.path.join(self.root, d)
            if _STEP_RE.match(d) and not is_committed(full):
                shutil.rmtree(full, ignore_errors=True)
