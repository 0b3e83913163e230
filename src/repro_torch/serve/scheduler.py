"""Slot scheduler for continuous batching.

Pure-python admission/eviction bookkeeping, kept model-free so the policy is
unit-testable without touching torch: a fixed number of decode slots, a pending
queue, and a slot -> request map.  The engine asks ``admit()`` for newly
filled slots each iteration and ``evict()``s a slot the moment its request
finishes — a new request then rides the very next decode step while the
other slots keep decoding (no head-of-line blocking).

Two admission policies:

``"fifo"`` (default)
    The original first-in-first-out queue, bit-compatible with the seed
    behaviour: no priorities, no deadlines, unbounded queue unless
    ``max_pending`` is set.

``"priority"``
    Production admission for the ``repro_torch.server`` frontend: requests carry a
    ``Priority`` tier and an optional TTFT SLO (``deadline_s``, seconds from
    submission).  Admission picks the highest tier first, tightest deadline
    within a tier (earliest-deadline-first), FIFO as the final tiebreak.
    Requests whose deadline has already expired while queued are *shed*
    (dropped with telemetry, never silently), and a bounded queue
    (``max_pending``) sheds the lowest-priority victim — or rejects the
    newcomer — when full, which is the backpressure signal the HTTP layer
    turns into 503s.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


class Priority(enum.IntEnum):
    """Request priority tier: higher value wins admission."""
    LOW = 0
    NORMAL = 1
    HIGH = 2


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    frames: Optional[Any] = None     # encdec only: (1, t_enc, d) frame embeds
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False          # cut short (budget / max_len), NOT completed
    # serving QoS (priority admission policy only; FIFO ignores both)
    priority: Priority = Priority.NORMAL
    deadline_s: Optional[float] = None   # TTFT SLO, seconds from submission
    shed: bool = False               # dropped by the scheduler, never decoded
    shed_reason: Optional[str] = None    # "queue_full" | "deadline"
    cancelled: bool = False          # caller abandoned it (disconnect/timeout);
    #                                  the engine reaps it at the next step
    # telemetry (clock readings, filled in by the engine)
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    # streaming hooks (set by the repro_torch.server frontend; the engine calls
    # on_token per emitted token and on_finish exactly once per terminal
    # state — completed, truncated, or shed)
    on_token: Optional[Callable[["Request", int], None]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    on_finish: Optional[Callable[["Request"], None]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _finish_fired: bool = \
        dataclasses.field(default=False, repr=False, compare=False)

    def fire_finish(self) -> bool:
        """Invoke ``on_finish`` exactly once, no matter how many terminal
        paths (shed, drain truncation, engine failure, normal completion)
        reach this request.  Returns True on the first (real) firing."""
        if self._finish_fired:
            return False
        self._finish_fired = True
        if self.on_finish is not None:
            self.on_finish(self)
        return True

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def deadline_t(self) -> Optional[float]:
        """Absolute first-token deadline (clock units), once submitted."""
        if self.deadline_s is None or self.submit_t is None:
            return None
        return self.submit_t + self.deadline_s

    def deadline_met(self) -> Optional[bool]:
        """Whether the first token arrived within the SLO (None: no SLO)."""
        if self.deadline_s is None:
            return None
        ttft = self.ttft_s
        return ttft is not None and ttft <= self.deadline_s

    @property
    def status(self) -> str:
        if self.shed:
            return "shed"
        if self.cancelled:
            return "cancelled"
        if self.truncated:
            return "truncated"
        if self.done:
            return "completed"
        return "pending" if not self.out_tokens else "running"


class SlotScheduler:
    """Admission of requests into a fixed set of decode slots.

    The default configuration (``policy="fifo"``, ``max_pending=None``) is
    bit-compatible with the original FIFO scheduler.
    """

    POLICIES = ("fifo", "priority")

    def __init__(self, slots: int, policy: str = "fifo",
                 max_pending: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 obs=None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"expected one of {self.POLICIES}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.slots = slots
        self.policy = policy
        self.max_pending = max_pending
        self.clock = clock
        self.obs = obs   # optional repro_torch.obs.ObsBus (shed trace events)
        self.pending: Deque[Request] = collections.deque()
        self.active: Dict[int, Request] = {}
        self.shed_requests: List[Request] = []

    # ---- queue side ----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request; returns False when it was shed instead.

        With a bounded queue, a full queue sheds the lowest-priority /
        latest-queued victim when the newcomer outranks it, otherwise the
        newcomer itself — strict backpressure either way.
        """
        if self.max_pending is not None \
                and len(self.pending) >= self.max_pending:
            victim_i = min(range(len(self.pending)),
                           key=lambda i: (self.pending[i].priority, -i))
            victim = self.pending[victim_i]
            if self.policy == "priority" and req.priority > victim.priority:
                del self.pending[victim_i]
                self._shed(victim, "queue_full")
            else:
                self._shed(req, "queue_full")
                return False
        self.pending.append(req)
        return True

    @property
    def n_pending(self) -> int:
        return len(self.pending)

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_shed(self) -> int:
        return len(self.shed_requests)

    def drained(self) -> bool:
        return not self.pending and not self.active

    # ---- shedding ------------------------------------------------------------

    def _shed(self, req: Request, reason: str) -> None:
        req.shed = req.done = True
        req.shed_reason = reason
        if self.clock is not None:
            req.finish_t = self.clock()
        self.shed_requests.append(req)
        if self.obs is not None:
            self.obs.event("request_shed", uid=req.uid, reason=reason,
                           priority=getattr(req.priority, "name",
                                            str(req.priority)),
                           queue_depth=len(self.pending))
        req.fire_finish()

    def expire_deadlines(self) -> List[Request]:
        """Shed queued requests whose TTFT deadline has already passed
        (priority policy with a clock only; FIFO never sheds)."""
        if self.policy != "priority" or self.clock is None:
            return []
        now = self.clock()
        expired = [r for r in self.pending
                   if r.deadline_t is not None and now > r.deadline_t]
        if expired:
            self.pending = collections.deque(
                r for r in self.pending if not (r.deadline_t is not None
                                                and now > r.deadline_t))
            for r in expired:
                self._shed(r, "deadline")
        return expired

    # ---- slot side -----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i in range(self.slots) if i not in self.active]

    def _pop_next(self) -> Request:
        if self.policy == "fifo":
            return self.pending.popleft()
        # highest tier first; earliest absolute deadline within a tier
        # (requests without an SLO sort last); FIFO as the final tiebreak
        best = min(range(len(self.pending)),
                   key=lambda i: (-self.pending[i].priority,
                                  self.pending[i].deadline_t
                                  if self.pending[i].deadline_t is not None
                                  else float("inf"),
                                  i))
        req = self.pending[best]
        del self.pending[best]
        return req

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the pending queue; returns the new
        (slot, request) assignments.  FIFO order under the default policy;
        priority/EDF order (after shedding expired deadlines) under
        ``policy="priority"``."""
        self.expire_deadlines()
        out: List[Tuple[int, Request]] = []
        for slot in self.free_slots():
            if not self.pending:
                break
            req = self._pop_next()
            self.active[slot] = req
            out.append((slot, req))
        return out

    def evict(self, slot: int) -> Request:
        if slot not in self.active:
            raise KeyError(f"slot {slot} is not active")
        return self.active.pop(slot)
