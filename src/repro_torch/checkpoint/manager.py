"""Checkpoint manager: async saves, keep-N retention, auto-resume (the
port of the reference's `checkpoint/manager.py`, for one card: its
`shardings` argument has no meaning there and is left out).

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
from typing import Any, List, Optional

import torch

from repro_torch.checkpoint.ckpt import (
    is_committed, restore_pytree, save_pytree,
)
from repro_torch.tree import tree_map

_STEP_RE = re.compile(r"^step_(\d+)$")


def host_snapshot(tree: Any) -> Any:
    """A copy of every tensor leaf in host memory (one synchronize, then
    blocking device-to-host copies): later updates of `tree` do not
    reach it."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
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
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write async."""
        self.wait()                       # one in-flight save at a time
        host_tree = host_snapshot(tree)
        target = self._dir(step)

        def _write():
            try:
                save_pytree(host_tree, target)
                self._gc()
            except BaseException as e:     # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------ #
    def restore(self, target: Any, *, step: Optional[int] = None,
                device=None) -> Any:
        """The checkpoint of `step` (default: the latest committed one)
        in `target`'s structure, on `device` (default: the CUDA card)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under "
                                    f"{self.root}")
        return restore_pytree(target, self._dir(step), device=device)

    def restore_or_init(self, target: Any, init_fn, *, device=None):
        """Auto-resume: restore the latest committed step or initialize.
        Returns (tree, start_step)."""
        step = self.latest_step()
        if step is None:
            return init_fn(), 0
        return self.restore(target, step=step, device=device), step

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
