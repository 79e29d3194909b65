"""JobQueue: typed, priority-scheduled thread pool.

Reference: src/ripple_core/functional/JobQueue.{h,cpp} over
beast::Workers — jobs carry a JobType with priority, per-type concurrency
limit and skip-on-overload flag (JobTypes.h:39-167); workers always pull
the highest-priority runnable job; per-type latency is sampled for load
shedding (LoadMonitor).

The job-type table is the batching seam (SURVEY §2.9): same-type jobs
(jtTRANSACTION, jtVALIDATION_*) form the natural batch dimension for the
device verify plane, which coalesces across jobs via VerifyPlane rather
than per-job synchronous verification.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Optional

__all__ = ["JobType", "JobQueue", "Job", "JOB_LIMITS"]


class JobType(IntEnum):
    """Priority-ordered job types (higher value = higher priority),
    following the reference table JobTypes.h:39-167 / Job.h:38-73."""

    jtPACK = 10  # make fetch pack
    jtPUBOLDLEDGER = 15
    jtVALIDATION_ut = 20  # untrusted validation
    jtPROOFWORK = 23
    jtTRANSACTION_l = 25  # local transaction
    jtPROPOSAL_ut = 30
    jtLEDGER_DATA = 40
    jtCLIENT = 45  # websocket command
    jtRPC = 50
    jtUPDATE_PF = 55
    jtTRANSACTION = 60  # network transaction
    jtADVANCE = 65
    jtPUBLEDGER = 70
    jtTXN_DATA = 75
    jtWAL = 80
    jtVALIDATION_t = 85  # trusted validation
    jtWRITE = 90
    jtACCEPT = 92
    jtPROPOSAL_t = 95
    jtSWEEP = 100
    jtNETOP_CLUSTER = 105
    jtNETOP_TIMER = 110
    jtADMIN = 115


@dataclass
class _Limits:
    limit: int = 0  # max concurrent (0 = unlimited)
    skip: bool = False  # skip-on-overload
    avg_ms: int = 0  # latency targets (load shedding signal)
    peak_ms: int = 0


# reference: JobTypes.h:47-128 (limit, skip, avg, peak)
JOB_LIMITS: dict[JobType, _Limits] = {
    JobType.jtPACK: _Limits(1, True, 0, 0),
    JobType.jtPUBOLDLEDGER: _Limits(2, False, 10000, 15000),
    JobType.jtVALIDATION_ut: _Limits(0, True, 2000, 5000),
    JobType.jtPROOFWORK: _Limits(0, True, 2000, 5000),
    JobType.jtTRANSACTION_l: _Limits(0, False, 100, 500),
    JobType.jtPROPOSAL_ut: _Limits(0, True, 500, 1250),
    JobType.jtLEDGER_DATA: _Limits(2, True, 0, 0),
    JobType.jtCLIENT: _Limits(0, True, 2000, 5000),
    JobType.jtRPC: _Limits(0, False, 0, 0),
    JobType.jtUPDATE_PF: _Limits(1, False, 0, 0),
    JobType.jtTRANSACTION: _Limits(0, False, 250, 1000),
    JobType.jtADVANCE: _Limits(0, False, 0, 0),
    JobType.jtPUBLEDGER: _Limits(0, False, 3000, 4500),
    JobType.jtTXN_DATA: _Limits(1, False, 0, 0),
    JobType.jtWAL: _Limits(0, False, 1000, 2500),
    JobType.jtVALIDATION_t: _Limits(0, False, 500, 1500),
    JobType.jtWRITE: _Limits(0, False, 1750, 2500),
    JobType.jtACCEPT: _Limits(0, False, 0, 0),
    JobType.jtPROPOSAL_t: _Limits(0, False, 100, 500),
    JobType.jtSWEEP: _Limits(0, True, 0, 0),
    JobType.jtNETOP_CLUSTER: _Limits(0, True, 9999, 9999),
    JobType.jtNETOP_TIMER: _Limits(0, True, 999, 999),
    JobType.jtADMIN: _Limits(0, False, 0, 0),
}


@dataclass(order=True)
class Job:
    sort_key: tuple = field(init=False)
    type: JobType = field(compare=False)
    seq: int = field(compare=False)
    name: str = field(compare=False, default="")
    work: Optional[Callable[[], None]] = field(compare=False, default=None)
    queued_at: float = field(compare=False, default=0.0)

    def __post_init__(self):
        # min-heap: invert priority; FIFO within a type
        self.sort_key = (-int(self.type), self.seq)


class _TypeStats:
    __slots__ = (
        "queued", "running", "finished", "dropped", "total_ms", "peak_ms",
        "ewma_ms",
    )

    def __init__(self):
        self.queued = 0
        self.running = 0
        self.finished = 0
        self.dropped = 0
        self.total_ms = 0.0
        self.peak_ms = 0.0
        # recent latency incl. queue wait (LoadMonitor role: the load
        # signal must react to the present, not the lifetime average)
        self.ewma_ms = 0.0


class JobQueue:
    """Priority thread pool with per-type concurrency limits."""

    def __init__(self, threads: int = 4, name: str = "jobq", tracer=None):
        from .tracer import get_tracer

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._heap: list[Job] = []
        self._seq = itertools.count()
        self._stats: dict[JobType, _TypeStats] = {t: _TypeStats() for t in JobType}
        self._stopping = False
        self._threads: list[threading.Thread] = []
        self._name = name
        self.tracer = tracer if tracer is not None else get_tracer()
        self.set_thread_count(threads)

    # -- submission -------------------------------------------------------

    def add_job(self, jtype: JobType, name: str, work: Callable[[], None]) -> bool:
        """Queue a job; returns False when shed by the skip-on-overload
        rule (reference: JobQueue::addJob + PeerImp backlog shed)."""
        lim = JOB_LIMITS[jtype]
        with self._lock:
            if self._stopping:
                return False
            st = self._stats[jtype]
            # skip-on-overload: shed when the per-type backlog is deep
            # (limit-bounded types shed at 2× their concurrency; unlimited
            # skip types at a fixed backlog, the reference's >100-queued
            # PeerImp shed writ large)
            if lim.skip:
                threshold = 2 * lim.limit if lim.limit else 256
                if st.queued >= threshold:
                    st.dropped += 1
                    return False
            st.queued += 1
            heapq.heappush(
                self._heap,
                Job(type=jtype, seq=next(self._seq), name=name, work=work,
                    queued_at=time.monotonic()),
            )
            self._cv.notify()
        return True

    def get_job_count(self, jtype: Optional[JobType] = None) -> int:
        with self._lock:
            if jtype is None:
                return sum(s.queued + s.running for s in self._stats.values())
            s = self._stats[jtype]
            return s.queued + s.running

    def is_overloaded(self) -> bool:
        """Any latency-targeted job type running over its average target
        (reference: JobQueue::isOverloaded → LoadMonitor::isOver). The
        EWMA includes queue wait, so a deep backlog trips this even while
        individual jobs are fast."""
        with self._lock:
            for t, s in self._stats.items():
                target = JOB_LIMITS[t].avg_ms
                if target and s.ewma_ms > target and (s.queued or s.running):
                    return True
        return False

    # -- worker loop ------------------------------------------------------

    def _next_runnable(self) -> Optional[Job]:
        """Pop the highest-priority job whose type is under its concurrency
        limit (reference: JobQueue::getNextJob skips over-limit types)."""
        deferred: list[Job] = []
        job = None
        while self._heap:
            cand = heapq.heappop(self._heap)
            lim = JOB_LIMITS[cand.type]
            if lim.limit and self._stats[cand.type].running >= lim.limit:
                deferred.append(cand)
                continue
            job = cand
            break
        for d in deferred:
            heapq.heappush(self._heap, d)
        return job

    def _worker(self) -> None:
        while True:
            with self._lock:
                job = self._next_runnable()
                while job is None and not self._stopping:
                    self._cv.wait(timeout=0.1)
                    job = self._next_runnable()
                if job is None and self._stopping:
                    return
                st = self._stats[job.type]
                st.queued -= 1
                st.running += 1
            t0 = time.monotonic()
            p0 = time.perf_counter()
            try:
                job.work()
            except Exception:  # noqa: BLE001 — a job must never kill a worker
                import traceback

                traceback.print_exc()
            now = time.monotonic()
            p1 = time.perf_counter()
            ms = (now - t0) * 1000
            # load signal includes the time spent waiting in the queue
            # (reference: LoadMonitor::addSamples measures from queue entry)
            wait_ms = (now - job.queued_at) * 1000
            # queue-wait vs run time per JobType for the tracing plane
            # (the wait interval is re-anchored onto the tracer's clock:
            # queued_at is monotonic, spans are perf_counter)
            tr = self.tracer
            if tr.enabled:
                wait_s = max(0.0, t0 - job.queued_at)
                jt = job.type.name
                tr.complete(f"jobq.{jt}.wait", "jobq", p0 - wait_s, p0,
                            job=job.name)
                tr.complete(f"jobq.{jt}.run", "jobq", p0, p1,
                            job=job.name)
            with self._lock:
                st.running -= 1
                st.finished += 1
                st.total_ms += ms
                st.peak_ms = max(st.peak_ms, ms)
                st.ewma_ms += 0.25 * (wait_ms - st.ewma_ms)
                # a slot freed for a limited type may unblock a deferred job
                self._cv.notify()

    # -- lifecycle --------------------------------------------------------

    def set_thread_count(self, n: int) -> None:
        while len(self._threads) < n:
            t = threading.Thread(
                target=self._worker, name=f"{self._name}-{len(self._threads)}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Drain: workers finish queued jobs then exit
        (reference: Stoppable onStop → Workers::pauseAllThreadsAndWait)."""
        with self._lock:
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=10)

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until no jobs are queued or running (test/standalone aid)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.get_job_count() == 0:
                return True
            time.sleep(0.002)
        return False

    # -- introspection (reference: JobQueue::getJson via get_counts) ------

    def get_json(self) -> dict:
        out = {}
        with self._lock:
            for t, s in self._stats.items():
                if s.finished or s.queued or s.running or s.dropped:
                    out[t.name] = {
                        "queued": s.queued,
                        "running": s.running,
                        "finished": s.finished,
                        "dropped": s.dropped,
                        "avg_ms": s.total_ms / s.finished if s.finished else 0.0,
                        "peak_ms": s.peak_ms,
                    }
        return out
