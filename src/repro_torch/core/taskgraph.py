"""Taskgraph workload specification (PnPSim §IV-A).

Each egocentric primitive implementation is a dataflow dependency graph.
Tasks carry architectural resource requirements: which device executes them,
how long (derived from measured FLOPs / device throughput), and how many
bytes they move.  Periodic sources (sensors) re-instantiate the graph at
their sampling rate; the engine schedules tasks against shared device
resources, capturing contention.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .engine import Environment, Resource, Telemetry


@dataclass(frozen=True)
class Task:
    name: str
    device: str                 # resource name it executes on
    duration_s: float           # service time per invocation
    deps: tuple[str, ...] = ()  # intra-graph dependencies
    bytes_out: float = 0.0      # data produced (moved over `out_device`)
    out_device: Optional[str] = None   # e.g. "dram_bus"


@dataclass(frozen=True)
class TaskGraph:
    name: str
    rate_hz: float              # instantiation rate (sensor-driven)
    tasks: tuple[Task, ...]
    deadline_s: Optional[float] = None

    def task(self, name: str) -> Task:
        for t in self.tasks:
            if t.name == name:
                return t
        raise KeyError(name)


def simulate(graphs: list[TaskGraph], devices: dict[str, int],
             horizon_s: float = 1.0,
             bus_bw: dict[str, float] | None = None) -> Telemetry:
    """Schedule periodic taskgraphs against shared resources.

    devices: resource name -> capacity.  bus_bw (optional): bytes/s per
    transfer resource — a task's ``bytes_out`` then *occupies*
    ``out_device`` for bytes/bw seconds (bus contention shows up as duty
    and queueing), instead of only being byte-accounted.  Returns duty
    cycles per resource, bytes moved, queueing stats, and deadline misses.

    Deadline misses are attributed per graph *instance*: each periodic
    instantiation gets its own completion barrier, and the barrier keeps
    working when instances overlap or tasks finish out of graph order
    (waiting on an already-completed task resumes immediately rather than
    deadlocking the checker).  On return, every in-flight task generator
    is closed and its device released/cancelled, so a truncated horizon
    cannot leave resources held at teardown.
    """
    env = Environment()
    res = {name: Resource(env, name, cap) for name, cap in devices.items()}
    tel = Telemetry()
    bus_bw = bus_bw or {}
    bytes_moved: dict[str, float] = {}
    procs: list = []                    # every task/transfer process started

    def transfer(dev: str, n_bytes: float):
        r = res[dev]
        req = r.request()
        try:
            yield req
            yield env.timeout(n_bytes / bus_bw[dev])
        finally:
            if req.triggered:
                r.release()
            else:
                r.cancel(req)

    def run_instance(graph: TaskGraph, t0: float):
        done: dict[str, object] = {}

        def run_task(task: Task):
            for d in task.deps:
                yield done[d]
            r = res[task.device]
            req = r.request()
            try:
                yield req
                yield env.timeout(task.duration_s)
            finally:
                # GeneratorExit at either yield still frees the device
                if req.triggered:
                    r.release()
                else:
                    r.cancel(req)
            if task.bytes_out and task.out_device:
                bytes_moved[task.out_device] = \
                    bytes_moved.get(task.out_device, 0.0) + task.bytes_out
                if task.out_device in bus_bw:
                    procs.append(env.process(
                        transfer(task.out_device, task.bytes_out)))

        for task in graph.tasks:
            done[task.name] = env.process(run_task(task))
        procs.extend(done.values())

        if graph.deadline_s is not None:
            def check():
                for t in graph.tasks:
                    yield done[t.name]
                if env.now - t0 > graph.deadline_s:
                    tel.deadline_misses += 1
            env.process(check())

    def source(graph: TaskGraph):
        period = 1.0 / graph.rate_hz
        t = 0.0
        while t < horizon_s:
            run_instance(graph, t)
            yield env.timeout(period)
            t += period

    for g in graphs:
        if g.rate_hz > 0:
            env.process(source(g))
    env.run(until=horizon_s)

    # teardown: drain every queue first so releasing a holder cannot
    # phantom-grant (and count a service for) work that never ran, then
    # close in-flight generators so held devices are released at the
    # horizon, not at GC time
    for r in res.values():
        for req in list(r.waiting):
            r.cancel(req)
    for p in procs:
        if not p.triggered:
            tel.open_instances += 1
            p.gen.close()

    for name, r in res.items():
        tel.duty[name] = r.duty_cycle(horizon_s)
        tel.services[name] = r.n_services
        tel.mean_wait[name] = (r.wait_time_total / r.n_services
                               if r.n_services else 0.0)
    tel.bytes_moved = bytes_moved
    return tel
