"""VerifyPlane: the coalescing device-batched signature pipeline.

The reference verifies each signature synchronously inside its own job
(PeerImp::checkTransaction → STTx::checkSign → libsodium); here,
verification requests from concurrent jobs are coalesced across an
adaptive window and dispatched as ONE device launch over the whole batch
(crypto.backend.BatchVerifier).

Routing: ``cost`` (default) measures both sides on the batches it
actually runs — a per-signature EWMA for the CPU path, a per-size-bucket
EWMA for the device — and sends each batch to the side predicted faster;
``device`` sends every batch of at least ``min_device_batch`` to the
device. A device call that overruns its deadline (utils.devicewatch)
raises ``DeviceWedged``, and so does every later batch of the plane:
no batch is verified on the CPU instead (``device_wedged`` in
get_json; a restart is the recovery).

The plane defaults to the ``cuda`` backend on the first CUDA device, so
a plane built without arguments runs on the card and raises where
there is none; ``backend="cpu"``, or ``backend_opts={"device": "cpu"}``
for K1's plain version, keeps it on the host.

Callers either:
- `submit(req) -> Future[bool]` — async, coalesced (the JobQueue path),
- `verify_many(reqs) -> ndarray` — blocking whole-batch.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from ..crypto.backend import BatchVerifier, VerifyRequest, make_verifier
from ..utils.devicewatch import (
    HEALTH, DeviceWedged, call_with_deadline, resolve_timeouts,
)
from .metrics import LatencyHist

log = logging.getLogger("stellard.device")

__all__ = ["VerifyPlane"]

# per-batch latency bucket upper bounds (ms); the +inf overflow bucket
# is implicit in LatencyHist
_HIST_BOUNDS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                1000.0)


class _LatencyModel:
    """Measured-cost model for the cpu-vs-device routing decision."""

    # after this many CPU-routed eligible batches, retry the device once
    # (load characteristics drift; a one-shot loss must not be forever)
    REEXPLORE_EVERY = 512

    def __init__(self, min_device_batch: int):
        self.min_device_batch = min_device_batch
        self.cpu_persig_ms: Optional[float] = None  # cost ~ linear in n
        self.device_bucket_ms: dict[int, float] = {}  # cost per size bucket
        self._device_warm: set[int] = set()
        self._since_device = 0
        self.lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        size = self.min_device_batch
        while size < n:
            size *= 2
        return size

    def observe_cpu(self, n: int, ms: float) -> None:
        if n <= 0:
            return
        with self.lock:
            per = ms / n
            if self.cpu_persig_ms is None:
                self.cpu_persig_ms = per
            else:
                self.cpu_persig_ms += 0.25 * (per - self.cpu_persig_ms)

    def observe_device(self, n: int, ms: float) -> None:
        b = self._bucket(max(n, 1))
        with self.lock:
            self._since_device = 0
            if b not in self._device_warm:
                # the first sample of a bucket may include the kernel
                # build; recording it would route every later batch to
                # the CPU
                self._device_warm.add(b)
                return
            cur = self.device_bucket_ms.get(b)
            self.device_bucket_ms[b] = ms if cur is None else cur + 0.25 * (ms - cur)

    def expected_cpu_ms(self, n: int) -> Optional[float]:
        with self.lock:
            return None if self.cpu_persig_ms is None else self.cpu_persig_ms * n

    def expected_device_ms(self, n: int) -> Optional[float]:
        b = self._bucket(max(n, 1))
        with self.lock:
            if b in self.device_bucket_ms:
                return self.device_bucket_ms[b]
            if self.device_bucket_ms:  # nearest measured bucket
                near = min(self.device_bucket_ms, key=lambda k: abs(k - b))
                return self.device_bucket_ms[near]
            return None

    def use_device(self, n: int, count: bool = True) -> bool:
        """Unmeasured sides are explored once a batch reaches
        min_device_batch; then measurements decide. ``count=False`` asks
        without advancing the re-exploration counter (the coalescing
        window polls this on every wake-up)."""
        if n < self.min_device_batch:
            return False
        dev = self.expected_device_ms(n)
        if dev is None:
            return True  # explore: one measurement teaches the model
        cpu = self.expected_cpu_ms(n)
        if cpu is None:
            return False  # measure the CPU too
        if dev < cpu:
            return True
        if not count or cpu * 4.0 < dev:
            return False
        with self.lock:
            self._since_device += 1
            if self._since_device >= self.REEXPLORE_EVERY:
                self._since_device = 0
                return True
        return False

    def get_json(self) -> dict:
        with self.lock:
            return {
                "cpu_persig_ms": self.cpu_persig_ms,
                "device_bucket_ms": dict(self.device_bucket_ms),
            }


class VerifyPlane:
    def __init__(
        self,
        backend: str = "cuda",
        window_ms: float = 2.0,
        max_batch: int = 16384,
        min_device_batch: int = 64,
        device_first_timeout: Optional[float] = None,
        device_warm_timeout: Optional[float] = None,
        tracer=None,
        backend_opts: Optional[dict] = None,
        routing: str = "cost",
    ):
        from .tracer import get_tracer

        if routing not in ("cost", "device"):
            raise ValueError(f"verify routing must be cost|device, got {routing!r}")
        self.tracer = tracer if tracer is not None else get_tracer()
        self.backend_name = backend
        # backend options flow to the factory verbatim (unknown keys
        # raise there)
        self.backend_opts = dict(backend_opts or {})
        self.verifier: BatchVerifier = make_verifier(backend, **self.backend_opts)
        self.cpu: BatchVerifier = (
            self.verifier if backend == "cpu" else make_verifier("cpu")
        )
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.min_device_batch = min_device_batch
        self.model = _LatencyModel(min_device_batch)
        self._device_capable = backend != "cpu"
        self.routing = routing
        self._route_by_cost = routing == "cost"
        # device-wedge deadlines: the first device call may build the
        # kernel (nvcc), so it gets the generous one
        self._t_first, self._t_warm = resolve_timeouts(
            device_first_timeout, device_warm_timeout
        )
        self._device_warm = False
        self.device_wedged = False
        # start_prewarm: set while the prewarm runs (a device batch waits
        # for it), and the error that failed it (raised to every later
        # device batch instead of answering from the CPU)
        self._prewarm_done = threading.Event()
        self._prewarm_done.set()
        self.prewarm_error: Optional[BaseException] = None

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list[tuple[VerifyRequest, Future]] = []
        self._stopping = False
        self.batches = 0
        self.verified = 0
        self.device_batches = 0
        self.cpu_batches = 0
        # per-SIGNATURE routing counters: device_sigs / verified is the
        # device share, which proves the device actually did the work
        self.device_sigs = 0
        self.cpu_sigs = 0
        self._hist: dict[str, LatencyHist] = {
            "cpu": LatencyHist(bounds=_HIST_BOUNDS),
            "device": LatencyHist(bounds=_HIST_BOUNDS),
        }
        self._flusher = threading.Thread(
            target=self._flush_loop, name="verify-plane", daemon=True
        )
        self._flusher.start()

    # -- async coalesced path --------------------------------------------

    def submit(self, req: VerifyRequest) -> "Future[bool]":
        fut: Future = Future()
        with self._lock:
            self._pending.append((req, fut))
            if len(self._pending) >= self.max_batch:
                self._cv.notify()
        return fut

    def _flush_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._stopping:
                    self._cv.wait(timeout=0.05)
                if self._stopping and not self._pending:
                    return
                # coalescing window: wait for more arrivals while the
                # backlog is below a full batch AND the device would
                # take the larger batch (holding a batch the CPU can
                # clear at once only adds latency)
                if len(self._pending) < self.max_batch and self._device_capable and (
                    not self._route_by_cost
                    or self.model.use_device(
                        max(len(self._pending), self.min_device_batch), count=False
                    )
                ):
                    self._cv.wait(timeout=self.window)
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch :]
            reqs = [r for r, _ in batch]
            try:
                results = self.verify_many(reqs)
            except Exception as exc:  # noqa: BLE001 — fail the futures, not the plane
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            for (_, fut), ok in zip(batch, results):
                fut.set_result(bool(ok))

    # -- blocking whole-batch path ---------------------------------------

    def _device_deadline(self, n: int) -> float:
        if not self._device_warm:
            return self._t_first
        hi = getattr(self.verifier, "max_batch", self.max_batch)
        return self._t_warm * max(1, -(-n // max(1, hi)))

    def start_prewarm(
        self, sizes: Optional[Sequence[int]] = None, rounds: int = 2
    ) -> threading.Thread:
        """Build K1 and measure the device's batch sizes OFF the traffic
        path (the JAX plane compiles its pad buckets here). ``sizes``
        defaults to every power-of-two size from ``min_device_batch`` to
        ``max_batch``, each run ``rounds`` times (at least twice: the
        first sample of a size may include the build and is discarded by
        the model). Join the returned thread for a deterministic warm
        start.

        Unlike the JAX plane, whose live batches ride the CPU until the
        prewarm ends and which logs a failed prewarm and carries on on
        the CPU, a device batch here waits for the prewarm, and a prewarm
        that fails to build or launch K1 leaves its error in
        ``prewarm_error``: every later device batch raises it, and the
        node's ``serve()`` fails. A deadline overrun (a wedge) is kept
        there too, and counted (``device_wedged``)."""
        if sizes is None:
            ladder = []
            size = max(1, self.min_device_batch)
            while size < self.max_batch:
                ladder.append(size)
                size *= 2
            ladder.append(self.max_batch)
            sizes = sorted(set(ladder))
        if self._device_capable:
            self._prewarm_done.clear()

        def run() -> None:
            try:
                if not self._device_capable:
                    return
                req = VerifyRequest(b"\x66" * 32, b"\x77" * 32, b"\x88" * 64)
                for size in sizes:
                    reqs = [req] * size
                    for _ in range(max(2, rounds)):
                        t0 = time.perf_counter()
                        call_with_deadline(
                            lambda: self.verifier.verify_batch(reqs),
                            self._device_deadline(size),
                            label="verify-prewarm",
                        )
                        self._device_warm = True
                        self.model.observe_device(
                            size, (time.perf_counter() - t0) * 1000.0
                        )
            except DeviceWedged as exc:
                self.device_wedged = True
                self.prewarm_error = exc
                log.error("verify prewarm: %s", exc)
            except Exception as exc:  # noqa: BLE001 — kept, raised by every device batch
                self.prewarm_error = exc
                log.error("verify prewarm failed: %r", exc)
            finally:
                self._prewarm_done.set()

        t = threading.Thread(target=run, name="verify-prewarm", daemon=True)
        t.start()
        return t

    def verify_many(self, reqs: Sequence[VerifyRequest]) -> np.ndarray:
        if not reqs:
            return np.zeros(0, bool)
        n = len(reqs)
        use_device = False
        if self._device_capable:
            self._prewarm_done.wait()
            if self.prewarm_error is not None:
                raise RuntimeError(
                    "the verify plane's device prewarm failed; no batch is "
                    "verified on the CPU instead"
                ) from self.prewarm_error
            if self.device_wedged or HEALTH.dead:
                self.device_wedged = True
                raise DeviceWedged(
                    "the verify plane's device is wedged; no batch is "
                    "verified on the CPU instead (restart the node)"
                )
            if self._route_by_cost:
                use_device = self.model.use_device(n)
            else:
                use_device = n >= self.min_device_batch
        if use_device:
            t0 = time.perf_counter()
            try:
                out = call_with_deadline(
                    lambda: self.verifier.verify_batch(reqs),
                    self._device_deadline(n),
                    label="verify-device",
                )
                t1 = time.perf_counter()
                ms = (t1 - t0) * 1000.0
                self._device_warm = True
                self.model.observe_device(n, ms)
                self.device_batches += 1
                self.device_sigs += n
                self._hist["device"].record(ms)
                self.batches += 1
                self.verified += n
                self.tracer.complete("verify.batch", "verify", t0, t1, n=n,
                                     routed="device")
                return out
            except DeviceWedged as exc:
                # the device is dead for the process: this batch and
                # every later one fail
                self.device_wedged = True
                log.error("verify plane: %s", exc)
                raise
        t0 = time.perf_counter()
        out = self.cpu.verify_batch(reqs)
        t1 = time.perf_counter()
        ms = (t1 - t0) * 1000.0
        # tiny batches carry un-amortized fixed overhead; folding them
        # into the per-sig EWMA would bias routing for large batches
        if n >= 8:
            self.model.observe_cpu(n, ms)
        self.cpu_batches += 1
        self.cpu_sigs += n
        self._hist["cpu"].record(ms)
        self.batches += 1
        self.verified += n
        self.tracer.complete("verify.batch", "verify", t0, t1, n=n,
                             routed="cpu")
        return out

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            self._cv.notify_all()
        self._flusher.join(timeout=10)

    def get_json(self) -> dict:
        describe = getattr(self.verifier, "describe", None)
        meter = getattr(self.verifier, "transfers", None)
        return {
            "backend": self.backend_name,
            "routing": self.routing,
            "device": describe() if describe is not None else None,
            "transfers": meter.get_json() if meter is not None else None,
            "host_impl": getattr(self.cpu, "impl", "?"),
            "batches": self.batches,
            "verified": self.verified,
            "device_batches": self.device_batches,
            "cpu_batches": self.cpu_batches,
            "device_sigs": self.device_sigs,
            "cpu_sigs": self.cpu_sigs,
            "device_wedged": self.device_wedged,
            "device_share": (
                round(self.device_sigs / self.verified, 4) if self.verified else 0.0
            ),
            "pending": len(self._pending),
            "model": self.model.get_json(),
            "latency_histogram_ms": {
                "edges": list(_HIST_BOUNDS),
                "cpu": list(self._hist["cpu"].counts),
                "device": list(self._hist["device"].counts),
                "cpu_quantiles": self._hist["cpu"].get_json(),
                "device_quantiles": self._hist["device"].get_json(),
            },
        }
