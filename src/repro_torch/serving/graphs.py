"""CUDA-graph capture of the engine's fused chunks (the counterpart of
the reference's `jax.jit` cache of `chunk_fn`, `gen_fn` and
`_serve_chunk_impl`).

A chunk function reads its inputs from tensors at fixed addresses (the
engine's arena: cache pools and tables, policy state, per-lane carries,
the fault plane's per-step rows), writes its final state back into
them in place, and returns its per-step rows. `ChunkGraphs.run(key,
fn)` keeps one `torch.cuda.CUDAGraph` per key, all in one memory pool:

  * the first key a process captures on a card runs `fn` eagerly on
    that card's capture stream (one per card, shared by every engine) —
    the chunk's real work, and the warm-up that capture needs (cuBLAS
    workspaces on that stream, the kernels' libraries and ticket
    counters) — and is then captured on the same stream, which records
    its work without running it;
  * every later new key is captured at once and replayed: the replay
    does the chunk's work;
  * every later time a key is seen its graph replays: the same
    launches, with no Python between them and no host sync inside the
    chunk.

A host sync inside `fn` makes the capture raise; nothing falls back to
the eager path. `captures` counts the captures by key (the reference's
`_serve_jit._cache_size()`); `replays` counts the replays. Each
kernel's launches in a graph are taken out of `build.COUNTS` at capture
(they did not run) and added back at every replay, so `COUNTS` counts
the launches the card ran: nodes per graph times replays, plus the
eager chunks'. On any device but CUDA `run` calls `fn` and keeps
nothing.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Hashable

import torch

from repro_torch.kernels.build import COUNTS

#: the capture stream of each card, and the cards whose capture stream
#: has run a chunk eagerly (the warm-up every later capture relies on)
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_WARM: set = set()


class ChunkGraphs:
    """One captured graph per key, on one device (see the module
    docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        #: captures by key
        self.captures: collections.Counter = collections.Counter()
        #: replays by key
        self.replays: collections.Counter = collections.Counter()
        #: key -> (graph, its outputs, its kernel launches per replay)
        self._graphs: Dict[Hashable, tuple] = {}
        self._pool = None

    def drop(self, which) -> None:
        """Drop the graphs whose key `which(key)` picks (their inputs
        are about to be replaced); the counts stay."""
        for key in [k for k in self._graphs if which(k)]:
            del self._graphs[key]

    def run(self, key: Hashable, fn: Callable[[], Any]) -> Any:
        """`fn()`'s result: by replaying the graph of `key` on the card,
        captured the first time the key is seen (after an eager run of
        `fn`, the warm-up, on a card that has had none)."""
        if self.device.type != "cuda":
            return fn()
        entry = self._graphs.get(key)
        if entry is None:
            if self.device not in _WARM:
                return self._run_and_capture(key, fn)
            entry = self._capture(key, fn)
        graph, out, launches = entry
        graph.replay()
        COUNTS.update(launches)
        self.replays[key] += 1
        return out

    @property
    def _stream(self) -> "torch.cuda.Stream":
        if self.device not in _STREAMS:
            _STREAMS[self.device] = torch.cuda.Stream(self.device)
        return _STREAMS[self.device]

    def _run_and_capture(self, key: Hashable, fn: Callable[[], Any]) -> Any:
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = fn()
        main.wait_stream(self._stream)
        _WARM.add(self.device)
        self._capture(key, fn)
        return out

    def _capture(self, key: Hashable, fn: Callable[[], Any]) -> tuple:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        before = collections.Counter(COUNTS)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                captured = fn()
        finally:
            launches = COUNTS - before
            COUNTS.clear()
            COUNTS.update(before)
        main.wait_stream(self._stream)
        self._graphs[key] = (graph, captured, launches)
        self.captures[key] += 1
        return self._graphs[key]
