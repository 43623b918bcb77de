"""Request scheduler: admission + continuous-batching bookkeeping.

Serving at scale needs more than a decode loop: requests arrive with
different prompt lengths and budgets, finish at different times, and
their KV pages must be reclaimed. This scheduler keeps a fixed-size
batch of live slots over the engine's paged cache:

  * admission — a request is admitted when a batch slot AND enough free
    logical pages exist (prompt + expected decode length);
  * completion — finished slots release their pages; the next queued
    request is admitted without stopping the batch (continuous
    batching, Sarathi/vLLM-style at step granularity);
  * fairness — FIFO with a starvation bound (max_skips).

Each request walks a lane state machine, mirrored on device by the
mixed prefill+decode serve loop:

  queued -> prefilling -> decoding -> done

Admission binds a lane and starts CHUNKED prefill: the lane consumes a
fixed token-budget slice of its prompt per fused step (`prefilled`
tracks progress) while other lanes decode; the first output token is
sampled on device at the step prefill crosses `prompt_len`
("decoding"), and EOS/budget completion frees the lane ("done").
Wall-clock stamps (`submitted_at` / `first_token_at` / `finished_at`)
feed the TTFT/TPOT percentiles in `ServeReport`.

The scheduler is pure control plane: it never touches arrays. Two ways
to drive it:

  * `step()` — the self-contained behavioural simulation (admit, count
    one generated token per live request, complete on budget);
  * `admit()` / `complete()` / `device_view()` — the engine-facing
    protocol used by `ServingEngine.serve`: the ENGINE decides when a
    request finishes (EOS or budget, observed on device) and calls
    `complete`; at every chunk boundary `device_view` exports the
    per-slot active mask, remaining-token budgets, and slot->cache-lane
    bindings that become the fused decode loop's carry.

Page accounting uses the engine's real page size (`page_tokens`,
stamped onto each request at submit) so the scheduler can never
diverge from the cache geometry.

This is the port's own copy of the reference's numpy-only
`serving/scheduler.py`; the port imports nothing of `repro`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

#: the exhaustive per-request dispositions (`Request.status`). Every
#: request that enters `ServingEngine.serve` (or is refused at submit)
#: ends in exactly one of these — the engine never raises mid-stream on
#: a per-request condition.
TERMINAL_STATUSES = ("ok", "rejected", "failed", "cancelled", "timeout")


@dataclasses.dataclass(frozen=True)
class RequestError:
    """Typed per-request error record, attached to `Request.error`
    whenever the terminal status is not "ok".

    code — machine-readable reason (e.g. "empty_prompt", "zero_budget",
           "infeasible_pages", "infeasible_context", "duplicate_rid",
           "poisoned_logits", "deadline_exceeded", "cancelled").
    detail — human-readable context for the report/logs.
    """

    code: str
    detail: str = ""


@dataclasses.dataclass
class Request:
    """One serving request: identity (`rid`), prompt, decode budget,
    and the per-run mutable bookkeeping the scheduler/engine stamp
    onto it (lane binding, phase, generated tokens, wall-clock
    latency marks). Reset on every `ContinuousBatcher.submit`, so a
    Request object can be re-submitted across serve calls."""

    rid: int
    prompt_len: int = 0
    max_new_tokens: int = 16
    #: prompt token ids (any int sequence) — required for real serving
    #: via `ServingEngine.serve`; optional for scheduler-only sims.
    prompt: Optional[object] = None
    #: page size used for page accounting; stamped by the batcher at
    #: submit so it always matches the engine's cache geometry.
    page_tokens: int = 16
    arrived_step: int = 0
    started_step: int = -1
    finished_step: int = -1
    generated: int = 0
    #: cache lane (batch row) bound while live; -1 when not in a slot
    lane: int = -1
    #: generated token ids (filled by the serving engine)
    output: List[int] = dataclasses.field(default_factory=list)
    #: lane state machine: queued -> prefilling -> decoding -> done
    phase: str = "queued"
    #: prompt tokens already consumed by chunked prefill
    prefilled: int = 0
    #: wall-clock request-latency stamps (TTFT = first_token_at -
    #: submitted_at; TPOT from first_token_at/finished_at/generated)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    #: terminal disposition ("pending" while in flight; ends in one of
    #: TERMINAL_STATUSES — see module constant)
    status: str = "pending"
    #: typed reason whenever status != "ok"
    error: Optional[RequestError] = None
    #: wall-clock deadline in seconds from submit (None = no deadline);
    #: checked by the engine at chunk boundaries -> status "timeout"
    deadline_s: Optional[float] = None
    #: cooperative cancellation flag (set via `cancel()`); honored by
    #: the engine at chunk boundaries -> status "cancelled"
    cancel_requested: bool = False
    #: open-loop arrival offset in seconds from stream start (the
    #: workload plane stamps this; `serve` submits the request at the
    #: first chunk boundary whose wall clock passes it — 0.0 = submit
    #: immediately, the pre-workload behavior)
    arrival_s: float = 0.0
    #: priority tier name (workload plane); an `SLOPolicy` maps it to
    #: per-tier TTFT/TPOT targets. None = no tier (never SLO-shed).
    tier: Optional[str] = None
    #: wall-clock instant the lane's first chunk started running —
    #: TTFT decomposes as queue_wait (admitted_at - submitted_at)
    #: + prefill_s + throttle_s (stamped by the engine; see
    #: EXPERIMENTS.md §Workloads)
    admitted_at: Optional[float] = None
    #: seconds of serve steps that consumed this request's prompt
    prefill_s: float = 0.0
    #: seconds the admitted lane sat prefill-stalled: prefill-budget
    #: bucket starvation plus chunk-boundary host overhead
    throttle_s: float = 0.0
    #: why an "ok" request stopped: "eos" | "budget" (None otherwise)
    stop_reason: Optional[str] = None

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Seconds from submit to the lane's first serve chunk (None
        until admitted)."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    def cancel(self) -> None:
        """Request cooperative cancellation: the engine reaps the
        request at the next chunk boundary (queued requests are
        dropped immediately; live ones release their lane + pages)."""
        self.cancel_requested = True

    def __post_init__(self):
        if self.prompt is not None and not self.prompt_len:
            self.prompt_len = int(np.asarray(self.prompt).shape[-1])

    @property
    def pages_needed(self) -> int:
        """KV pages this request needs end-to-end (prompt + full decode
        budget), under the page size stamped at submit."""
        return -(-(self.prompt_len + self.max_new_tokens)
                 // self.page_tokens)


@dataclasses.dataclass
class SlotState:
    """One batch slot: the live request bound to it, or None if free."""

    request: Optional[Request] = None

    @property
    def free(self) -> bool:
        """Whether the slot can accept an admission."""
        return self.request is None


@dataclasses.dataclass
class DeviceView:
    """Device-facing snapshot of the batch: what the fused mixed
    prefill+decode loop needs to know, as arrays (see
    ServingEngine.serve). The per-lane mode (prefilling vs decoding) is
    derived ON DEVICE as `prefilled < prompt_len`, so the view is also
    the chunk carry."""
    active: np.ndarray       # [num_slots] bool — slot has a live request
    remaining: np.ndarray    # [num_slots] int32 — token budget left
    rids: np.ndarray         # [num_slots] int32 — request id, -1 if free
    prompt_len: np.ndarray   # [num_slots] int32 — prompt tokens, 0 if free
    prefilled: np.ndarray    # [num_slots] int32 — prompt progress
    lane_of: Dict[int, int]  # rid -> cache lane (page-table binding)


class ContinuousBatcher:
    """Fixed-slot continuous-batching scheduler over the paged cache
    (admission / completion / fairness — see the module docstring).
    Pure control plane: never touches arrays; the engine drives it via
    `admit`/`complete`/`device_view` at chunk boundaries."""

    def __init__(self, num_slots: int, total_pages: int,
                 page_tokens: int = 16, max_skips: int = 8):
        self.slots: List[SlotState] = [SlotState() for _ in range(num_slots)]
        self.total_pages = total_pages
        self.free_pages = total_pages
        self.page_tokens = page_tokens
        self.queue: Deque[Request] = deque()
        self.max_skips = max_skips
        self.step_idx = 0
        self.completed: List[Request] = []
        #: requests refused at submit/admission (never held a slot);
        #: each carries status="rejected" and a typed `error`
        self.rejected: List[Request] = []
        #: lane<->request attribution ledger: one row per admission,
        #: in admission order. Lane indices are REUSED across the
        #: stream, so request identity over time comes from these
        #: bindings (+ the per-chunk `DeviceView.rids` stamps the
        #: engine logs) — the trace bridge's per-request stitching
        #: relies on exactly this: a lane's telemetry belongs to
        #: whichever request was bound at that step, never to the
        #: lane number itself.
        self.bindings: List[Dict[str, int]] = []

    # ------------------------------------------------------------------ #
    def reject(self, req: Request, code: str, detail: str = "") -> None:
        """Refuse a request with a typed error record: status
        "rejected", never occupies a slot, lands in `self.rejected`.
        Also the path for reaping QUEUED requests (deadline/cancel
        before admission) — the stream keeps serving everyone else."""
        req.status = "rejected"
        req.error = RequestError(code=code, detail=detail)
        req.phase = "done"
        req.finished_step = self.step_idx
        req.finished_at = time.time()
        self.rejected.append(req)

    def drop_queued(self, req: Request, status: str, code: str,
                    detail: str = "") -> None:
        """Reap a QUEUED request with a terminal status ("cancelled" /
        "timeout"): removed from the queue, no pages to release, lands
        in `rejected` (it never held a slot)."""
        assert status in TERMINAL_STATUSES and status != "ok", status
        self.queue.remove(req)
        req.status = status
        req.error = RequestError(code=code, detail=detail)
        req.phase = "done"
        req.finished_step = self.step_idx
        req.finished_at = time.time()
        self.rejected.append(req)

    def _reset_run_state(self, req: Request) -> None:
        """Reset per-run mutable state so a Request object can be
        re-submitted (fresh serve call / sim) without carrying the
        previous run's tokens, bindings, or disposition."""
        req.page_tokens = self.page_tokens
        req.arrived_step = self.step_idx
        req.started_step = -1
        req.finished_step = -1
        req.generated = 0
        req.lane = -1
        req.output = []
        req.phase = "queued"
        req.prefilled = 0
        req.submitted_at = time.time()
        req.first_token_at = None
        req.finished_at = None
        req.status = "pending"
        req.error = None
        req.cancel_requested = False
        req.admitted_at = None
        req.prefill_s = 0.0
        req.throttle_s = 0.0
        req.stop_reason = None

    def reject_submit(self, req: Request, code: str,
                      detail: str = "") -> None:
        """Reset + reject in one step — for callers (the engine) that
        validate request CONTENTS (prompt presence, decode budget,
        cache-capacity fit) above the scheduler's pool accounting."""
        self._reset_run_state(req)
        self.reject(req, code, detail)

    def submit(self, req: Request) -> bool:
        """Queue a request (FIFO) and reset its per-run state.

        Returns True when queued. Requests that can NEVER be served —
        duplicate rid against a queued/live request (the bindings
        ledger and `complete()` match by rid, so a duplicate would
        corrupt per-request attribution), or a page footprint larger
        than the whole pool — are rejected with a typed error instead
        of poisoning the stream; the caller's other requests proceed.
        """
        self._reset_run_state(req)
        live = {s.request.rid for s in self.slots if s.request is not None}
        if any(q.rid == req.rid for q in self.queue) or req.rid in live:
            self.reject(req, "duplicate_rid",
                        f"rid {req.rid} already queued or live")
            return False
        if req.pages_needed > self.total_pages:
            self.reject(
                req, "infeasible_pages",
                f"needs {req.pages_needed} pages, pool has "
                f"{self.total_pages}")
            return False
        self.queue.append(req)
        return True

    def admit(self) -> List[Request]:
        """Admit queued requests into free slots (FIFO, starvation-bounded
        leapfrogging). Returns the newly admitted requests, each with its
        `lane` binding set."""
        skips = 0
        admitted: List[Request] = []
        requeue: List[Request] = []
        while self.queue and skips <= self.max_skips:
            lane = next((i for i, s in enumerate(self.slots) if s.free),
                        None)
            if lane is None:
                break
            req = self.queue.popleft()
            if req.pages_needed > self.total_pages:
                # pool shrank below this request's footprint after it
                # was queued — permanently unfittable; reject instead
                # of requeueing forever (deadlock under shrink faults)
                self.reject(
                    req, "infeasible_pages",
                    f"needs {req.pages_needed} pages, pool shrank to "
                    f"{self.total_pages}")
                continue
            if req.pages_needed <= self.free_pages:
                self.slots[lane].request = req
                req.lane = lane
                req.started_step = self.step_idx
                req.phase = "prefilling"
                self.free_pages -= req.pages_needed
                self.bindings.append({
                    "rid": req.rid, "lane": lane,
                    "admitted_step": self.step_idx,
                    "released_step": -1})
                admitted.append(req)
            else:
                requeue.append(req)
                skips += 1
        for r in reversed(requeue):
            self.queue.appendleft(r)
        return admitted

    def complete(self, req: Request, status: str = "ok",
                 error: Optional[RequestError] = None) -> None:
        """Release a live request's slot and pages with a terminal
        `status` (engine-driven: "ok" on EOS/budget; "failed" /
        "cancelled" / "timeout" when the engine quarantines or reaps a
        lane — pages release either way, the stream keeps serving)."""
        assert req.lane >= 0 and self.slots[req.lane].request is req, req
        assert status in TERMINAL_STATUSES, status
        for b in reversed(self.bindings):
            if b["rid"] == req.rid and b["released_step"] < 0:
                b["released_step"] = self.step_idx
                break
        self.slots[req.lane].request = None
        self.free_pages += req.pages_needed
        req.finished_step = self.step_idx
        req.finished_at = time.time()
        req.phase = "done"
        req.lane = -1
        req.status = status
        req.error = error
        self.completed.append(req)

    def resize_pool(self, delta: int) -> int:
        """Grow (+) or shrink (-) the page pool by `delta` pages — the
        scheduler half of a PoolFault. Reserved pages stay reserved:
        a shrink can drive `free_pages` negative, which simply stalls
        admission until completions release enough pages (admission
        requires `pages_needed <= free_pages`). The pool floor is 0.
        Returns the delta actually applied."""
        delta = int(delta)
        if self.total_pages + delta < 0:
            delta = -self.total_pages
        self.total_pages += delta
        self.free_pages += delta
        return delta

    def live_requests(self) -> List[Request]:
        """The requests currently bound to slots, in lane order."""
        return [s.request for s in self.slots if s.request is not None]

    # ------------------------------------------------------------------ #
    def device_view(self) -> DeviceView:
        """Export the per-slot arrays the fused serve chunk carries
        (active/remaining/rids/prompt_len/prefilled + lane bindings)."""
        n = len(self.slots)
        active = np.zeros((n,), bool)
        remaining = np.zeros((n,), np.int32)
        rids = np.full((n,), -1, np.int32)
        prompt_len = np.zeros((n,), np.int32)
        prefilled = np.zeros((n,), np.int32)
        lane_of: Dict[int, int] = {}
        for i, s in enumerate(self.slots):
            r = s.request
            if r is None:
                continue
            active[i] = True
            remaining[i] = r.max_new_tokens - r.generated
            rids[i] = r.rid
            prompt_len[i] = r.prompt_len
            prefilled[i] = r.prefilled
            lane_of[r.rid] = i
        return DeviceView(active=active, remaining=remaining, rids=rids,
                          prompt_len=prompt_len, prefilled=prefilled,
                          lane_of=lane_of)

    @property
    def has_work(self) -> bool:
        """Whether anything is queued or still live in a slot."""
        return bool(self.queue) or any(not s.free for s in self.slots)

    # ------------------------------------------------------------------ #
    def step(self) -> List[Request]:
        """Behavioural simulation: advance one decode step; returns the
        active requests. (The real engine drives admit/complete itself.)"""
        self.admit()
        active = []
        for s in self.slots:
            r = s.request
            if r is None:
                continue
            r.generated += 1
            if r.generated >= r.max_new_tokens:
                self.complete(r)
            else:
                active.append(r)
        self.step_idx += 1
        return active

    # ------------------------------------------------------------------ #
    def utilization(self) -> float:
        """Fraction of batch slots holding a live request."""
        live = sum(0 if s.free else 1 for s in self.slots)
        return live / len(self.slots)

    def page_pressure(self) -> float:
        """Fraction of the KV page pool currently reserved (1.0 when a
        shrink fault has emptied the pool entirely)."""
        if self.total_pages <= 0:
            return 1.0
        return 1.0 - self.free_pages / self.total_pages
