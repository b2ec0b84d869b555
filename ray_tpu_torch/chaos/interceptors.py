"""RPC-layer fault interceptor.

Installs on :mod:`ray_tpu_torch._private.rpc`'s process-wide send hook
(``rpc.set_send_interceptor``) and applies a :class:`FaultSchedule` to every
outbound frame from this process — GCS, raylets, and the driver core all
share the hook, so one schedule can delay control-plane calls, drop one-way
``PushChunk`` frames mid-object-transfer, duplicate a lease request, or swap
the order of adjacent matching frames, without any daemon knowing chaos is
installed.

Scope: SEND-side only. Frames arriving from out-of-process peers (worker
subprocesses) are not intercepted; in the in-process cluster harness that
still covers every raylet<->raylet, raylet<->GCS and driver->anything frame.

All methods run on the event-loop thread (every ``_send_nowait`` does).
"""

from __future__ import annotations

import logging
from fnmatch import fnmatch
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import rpc
from ray_tpu_torch.chaos.schedule import FaultEvent, FaultLog, FaultSchedule, FaultSpec

logger = logging.getLogger(__name__)

_KIND_TO_CLASS = {0: "request", 1: "reply", 2: "reply", 3: "push"}


def _frame_class(msg: list) -> str:
    """Map a frame to its fault class. Blob frames (kinds 4/5) carry a raw
    byte sidecar but classify like their control twin: a kind-4 blob with
    msgid 0 is a one-way push, with a msgid it is a request; kind 5 is a
    reply. The rpc layer materializes the sidecar before offering the frame
    here, so drop/delay/dup treat control frame + payload as ONE unit."""
    kind = msg[1]
    if kind == 4:
        return "push" if not msg[0] else "request"
    if kind == 5:
        return "reply"
    return _KIND_TO_CLASS.get(kind, "request")


class ChaosInterceptor:
    """Applies a schedule's decisions to outbound frames.

    Decision semantics per matched frame:

    - ``drop``     — the frame is consumed and never sent. For a one-way push
                     that is silent loss; for a request the caller rides its
                     timeout; for a reply the peer does.
    - ``delay t``  — the frame is sent after ``t`` seconds via the
                     interceptor-bypassing ``_send_direct`` (so the delayed
                     copy is not re-faulted).
    - ``dup``      — the frame is sent now AND once more in the same loop
                     tick (the duplicate bypasses the interceptor).
    - ``reorder``  — the frame is held; the NEXT frame matching the same spec
                     is sent first, then the held one (adjacent swap). Held
                     frames are flushed by ``flush_held`` at uninstall.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.log = FaultLog()
        self._match_counts: Dict[str, int] = {s.name: 0 for s in schedule.specs}
        self._held: Dict[str, Tuple[rpc.Connection, list]] = {}
        self._timers: List = []

    # -- frame hook (rpc._send_nowait) --------------------------------------

    def __call__(self, conn: rpc.Connection, msg: list) -> bool:
        """Return True when the frame was consumed (rpc must not send it)."""
        try:
            method = msg[2]
            frame_class = _frame_class(msg)
        except Exception:
            return False
        if method == "LeaseBatch" and msg[1] == 3 and isinstance(msg[3], dict):
            # A lease batch is a transport envelope, not a lease op: faults
            # target the entries it carries, so dedup/cancel/exactly-once
            # invariants are exercised per lease exactly as they were when
            # each op rode its own frame.
            return self._intercept_batch(conn, msg)
        spec = self._match(method, frame_class)
        if spec is None:
            return False
        idx = self._match_counts[spec.name]
        self._match_counts[spec.name] = idx + 1
        action = self.schedule.decision(spec.name, idx)
        if action is None:
            return self._passthrough_reorder(spec, conn, msg)
        self.log.record(FaultEvent(spec.name, idx, action, method, msg[1]))
        kind = action[0]
        if kind == "drop":
            return True
        if kind == "delay":
            loop = conn._loop
            timer = loop.call_later(action[1], conn._send_direct, msg)
            self._timers.append(timer)
            return True
        if kind == "dup":
            # One extra copy, bypassing the interceptor; the original flows
            # normally (return False) so both land in the same flush.
            conn._send_direct(msg)
            return False
        if kind == "reorder":
            held = self._held.pop(spec.name, None)
            if held is not None:
                # Two holds back to back: release the older one first.
                held[0]._send_direct(held[1])
            self._held[spec.name] = (conn, msg)
            return True
        return False

    @staticmethod
    def _entry_frame(entry: list) -> list:
        """Re-expand one batch entry ``[msgid, method, payload, deadline,
        tctx]`` into the singleton request frame ``_flush_batch`` would have
        sent for it — the form delayed/duplicated/reordered copies travel
        in (the pack layer re-derives the wire TTL from the absolute
        deadline at actual send time, so a delayed entry's budget keeps
        shrinking while it is held)."""
        msgid, method, payload, deadline, tctx = entry
        frame = [msgid, 0, method, payload]
        if deadline is not None or tctx is not None:
            frame.append(deadline)
        if tctx is not None:
            frame.append(tctx)
        return frame

    def _intercept_batch(self, conn: rpc.Connection, msg: list) -> bool:
        """Apply the schedule to each LeaseBatch entry independently:
        surviving entries are repacked into the (mutated in place) batch;
        dropped ones vanish; delayed/duplicated/reordered ones leave the
        batch and travel as singleton request frames via the
        interceptor-bypassing ``_send_direct``. Consuming every entry
        consumes the whole frame."""
        entries = msg[3].get("entries") or []
        survivors: List[list] = []
        changed = False
        for entry in entries:
            emethod = entry[1]
            spec = self._match(emethod, "request")
            if spec is None:
                survivors.append(entry)
                continue
            idx = self._match_counts[spec.name]
            self._match_counts[spec.name] = idx + 1
            action = self.schedule.decision(spec.name, idx)
            if action is None:
                held = self._held.pop(spec.name, None)
                if held is not None:
                    # Adjacent swap across the batch boundary: this entry
                    # goes first (as a singleton), the held frame behind it.
                    conn._send_direct(self._entry_frame(entry))
                    held[0]._send_direct(held[1])
                    changed = True
                    continue
                survivors.append(entry)
                continue
            self.log.record(FaultEvent(spec.name, idx, action, emethod, 0))
            kind = action[0]
            if kind == "drop":
                changed = True
                continue
            if kind == "delay":
                timer = conn._loop.call_later(
                    action[1], conn._send_direct, self._entry_frame(entry)
                )
                self._timers.append(timer)
                changed = True
                continue
            if kind == "dup":
                conn._send_direct(self._entry_frame(entry))
                survivors.append(entry)
                continue
            if kind == "reorder":
                held = self._held.pop(spec.name, None)
                if held is not None:
                    held[0]._send_direct(held[1])
                self._held[spec.name] = (conn, self._entry_frame(entry))
                changed = True
                continue
            survivors.append(entry)
        if not changed:
            return False
        if not survivors:
            return True
        msg[3]["entries"] = survivors
        return False

    def _passthrough_reorder(
        self, spec: FaultSpec, conn: rpc.Connection, msg: list
    ) -> bool:
        """A non-fired match still releases a frame held by a reorder on the
        same spec — the adjacent swap: current frame first, held frame
        right behind it."""
        held = self._held.pop(spec.name, None)
        if held is None:
            return False
        conn._send_direct(msg)
        held[0]._send_direct(held[1])
        return True

    def _match(self, method: str, frame_class: str) -> Optional[FaultSpec]:
        for spec in self.schedule.specs:
            if spec.frame not in ("any", frame_class):
                continue
            if fnmatch(method, spec.method):
                return spec
        return None

    # -- lifecycle -----------------------------------------------------------

    def flush_held(self) -> None:
        """Deliver every held (reorder) frame and cancel pending delay
        timers' bookkeeping list. Called at uninstall so no frame is lost to
        schedule teardown (delay timers themselves still fire; _send_direct
        no-ops on closed connections)."""
        held, self._held = self._held, {}
        for conn, msg in held.values():
            conn._send_direct(msg)
        self._timers = [t for t in self._timers if not t.cancelled()]


def install(schedule: FaultSchedule) -> ChaosInterceptor:
    """Install a schedule process-wide. Returns the live interceptor (its
    ``log`` fills as faults fire). Loop thread only."""
    if rpc.get_send_interceptor() is not None:
        raise RuntimeError("a chaos interceptor is already installed")
    interceptor = ChaosInterceptor(schedule)
    rpc.set_send_interceptor(interceptor)
    return interceptor


def uninstall() -> Optional[ChaosInterceptor]:
    """Remove the installed interceptor (if any), flushing held frames so
    in-flight reorders complete. Loop thread only."""
    interceptor = rpc.get_send_interceptor()
    rpc.set_send_interceptor(None)
    if isinstance(interceptor, ChaosInterceptor):
        interceptor.flush_held()
        return interceptor
    return None
