"""Discrete-event simulation engine (PnPSim substrate).

The paper builds PnPSim on simpy; simpy is not available offline, so this is
our own generator-coroutine event engine with the same primitives the paper's
methodology needs: processes, timeouts, FIFO resources with contention, and
per-resource busy-interval telemetry (the duty cycles that drive the
state-based power models in power.py).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Generator, Optional


class Event:
    """One-shot event; processes yield these to wait."""

    __slots__ = ("env", "callbacks", "triggered", "dispatched", "value")

    def __init__(self, env: "Environment"):
        self.env = env
        self.callbacks: list[Callable[["Event"], None]] = []
        self.triggered = False
        self.dispatched = False     # callbacks already fired by the loop
        self.value: Any = None

    def succeed(self, value: Any = None) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self.value = value
        self.env._schedule(self.env.now, self)
        return self


class Timeout(Event):
    def __init__(self, env: "Environment", delay: float, value: Any = None):
        super().__init__(env)
        if delay < 0:
            raise ValueError("negative delay")
        self.triggered = True
        self.value = value
        env._schedule(env.now + delay, self)


class Process(Event):
    """Wraps a generator; the process event triggers when the gen returns."""

    def __init__(self, env: "Environment", gen: Generator):
        super().__init__(env)
        self.gen = gen
        self._resume(None)

    def _resume(self, value: Any):
        try:
            target = self.gen.send(value)
        except StopIteration as stop:
            if not self.triggered:
                self.succeed(getattr(stop, "value", None))
            return
        if not isinstance(target, Event):
            raise TypeError(f"process yielded {type(target)}, not Event")
        if target.dispatched:
            # Waiting on an event whose callbacks already fired (e.g. a
            # dependency that completed earlier in simulated time) must
            # resume immediately, not hang: re-arm on a zero-delay timeout
            # so FIFO ordering at the current instant is preserved.
            bounce = Timeout(self.env, 0.0, target.value)
            bounce.callbacks.append(lambda ev: self._resume(ev.value))
            return
        target.callbacks.append(lambda ev: self._resume(ev.value))


class Environment:
    def __init__(self):
        self.now: float = 0.0
        self._queue: list[tuple[float, int, Event]] = []
        self._counter = itertools.count()

    def _schedule(self, t: float, ev: Event):
        heapq.heappush(self._queue, (t, next(self._counter), ev))

    def timeout(self, delay: float, value: Any = None) -> Timeout:
        return Timeout(self, delay, value)

    def event(self) -> Event:
        return Event(self)

    def process(self, gen: Generator) -> Process:
        return Process(self, gen)

    def run(self, until: float):
        while self._queue and self._queue[0][0] <= until:
            t, _, ev = heapq.heappop(self._queue)
            self.now = t
            for cb in list(ev.callbacks):
                cb(ev)
            ev.callbacks.clear()
            ev.dispatched = True
        self.now = until


class _Request(Event):
    """Resource claim; identity-compared (never value-compared) so queue
    membership tests and cancellation target the exact request object."""

    def __init__(self, env, resource):
        Event.__init__(self, env)
        self.resource = resource


class Resource:
    """FIFO resource with capacity (compute IP, bus, radio...).

    Tracks busy intervals so the simulation can report a duty cycle —
    PnPSim's device-state telemetry.
    """

    def __init__(self, env: Environment, name: str, capacity: int = 1):
        self.env = env
        self.name = name
        self.capacity = capacity
        self.in_use = 0
        self.waiting: list[_Request] = []
        self.busy_time = 0.0
        self._busy_since: Optional[float] = None
        self.n_services = 0
        self.wait_time_total = 0.0
        self._req_times: dict[int, float] = {}

    def request(self) -> Event:
        req = _Request(self.env, self)
        self._req_times[id(req)] = self.env.now
        if self.in_use < self.capacity:
            self._grant(req)
        else:
            self.waiting.append(req)
        return req

    def _grant(self, req: _Request):
        self.in_use += 1
        self.n_services += 1
        self.wait_time_total += self.env.now - self._req_times.pop(
            id(req), self.env.now)
        if self.in_use == 1:
            self._busy_since = self.env.now
        req.succeed(self)

    def cancel(self, req: Event) -> None:
        """Withdraw a request that was never granted (process teardown)."""
        if req in self.waiting:
            self.waiting.remove(req)
            self._req_times.pop(id(req), None)

    def release(self):
        self.in_use -= 1
        if self.in_use == 0 and self._busy_since is not None:
            self.busy_time += self.env.now - self._busy_since
            self._busy_since = None
        if self.waiting and self.in_use < self.capacity:
            self._grant(self.waiting.pop(0))

    def duty_cycle(self, horizon: float) -> float:
        busy = self.busy_time
        if self._busy_since is not None:
            busy += self.env.now - self._busy_since
        return min(busy / horizon, 1.0) if horizon > 0 else 0.0


@dataclass
class Telemetry:
    """Simulation outputs per resource: the duty cycles + queueing stats."""
    duty: dict[str, float] = field(default_factory=dict)
    services: dict[str, int] = field(default_factory=dict)
    mean_wait: dict[str, float] = field(default_factory=dict)
    bytes_moved: dict[str, float] = field(default_factory=dict)
    deadline_misses: int = 0
    open_instances: int = 0     # task processes still in flight at teardown
