"""VerifyPlane: the coalescing device-batched signature pipeline.

The reference verifies each signature synchronously inside its own job
(PeerImp::checkTransaction → STTx::checkSign → libsodium); here,
verification requests from concurrent jobs are coalesced across an
adaptive window and dispatched as ONE device launch over the whole batch
(crypto.backend.BatchVerifier).

Routing: ``cost`` (default) measures every side on the batches it
actually runs — a per-signature EWMA for the CPU path, a per-size-bucket
EWMA for each device arm — and sends each batch to the side predicted
faster; ``device`` sends every batch of at least ``min_device_batch`` to
the widest device arm. When the backend's ``mesh=`` asks for more than
one device and the verifier resolves to more than one, the plane has
two device arms of the same verifier: ``dev1`` at width 1 and ``devN``
at the mesh's width, so that medium batches take one card and only
batches that pay for the split go wide (the JAX plane's model; on CUDA
the split is not measured yet). A mesh that resolves to one device has
the one arm ``device``.
A device call that overruns its deadline (utils.devicewatch) raises
``DeviceWedged``, and so does every later batch of the plane: no batch
is verified on the CPU instead (``device_wedged`` in get_json; a
restart is the recovery).

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
    """Measured-cost model for the routing decision: the CPU and one or
    more device ARMS (``device``, or ``dev1`` and ``devN`` with a mesh)."""

    # after this many CPU-routed eligible batches, retry a device arm
    # once (load characteristics drift; a one-shot loss must not be
    # forever)
    REEXPLORE_EVERY = 512

    def __init__(self, min_device_batch: int,
                 device_arms: Sequence[str] = ("device",)):
        self.min_device_batch = min_device_batch
        self.device_arms = tuple(device_arms)
        self.cpu_persig_ms: Optional[float] = None  # cost ~ linear in n
        # cost per size bucket, one map per arm
        self._bucket_ms: dict[str, dict[int, float]] = {a: {} for a in self.device_arms}
        self._device_warm: set[tuple[str, int]] = set()
        self._since: dict[str, int] = {a: 0 for a in self.device_arms}
        self.lock = threading.Lock()

    @property
    def device_bucket_ms(self) -> dict[int, float]:
        """The widest arm's buckets."""
        return self._bucket_ms[self.device_arms[-1]]

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

    def observe_device(self, n: int, ms: float, arm: Optional[str] = None) -> None:
        arm = arm if arm is not None else self.device_arms[-1]
        b = self._bucket(max(n, 1))
        with self.lock:
            self._since[arm] = 0
            if (arm, b) not in self._device_warm:
                # the first sample of an arm's bucket may include the
                # kernel build; recording it would route every later
                # batch to the CPU
                self._device_warm.add((arm, b))
                return
            buckets = self._bucket_ms[arm]
            cur = buckets.get(b)
            buckets[b] = ms if cur is None else cur + 0.25 * (ms - cur)

    def expected_cpu_ms(self, n: int) -> Optional[float]:
        with self.lock:
            return None if self.cpu_persig_ms is None else self.cpu_persig_ms * n

    def expected_device_ms(self, n: int, arm: Optional[str] = None) -> Optional[float]:
        arm = arm if arm is not None else self.device_arms[-1]
        b = self._bucket(max(n, 1))
        with self.lock:
            buckets = self._bucket_ms[arm]
            if b in buckets:
                return buckets[b]
            if buckets:  # nearest measured bucket
                near = min(buckets, key=lambda k: abs(k - b))
                return buckets[near]
            return None

    def route(self, n: int, count: bool = True) -> str:
        """``"cpu"`` or the device arm for an n-signature batch.
        Unmeasured arms are explored (in declared order) once a batch
        reaches min_device_batch; then measurements decide, the cheapest
        arm winning. ``count=False`` asks without advancing the
        re-exploration counters (the coalescing window polls this on
        every wake-up)."""
        avail = self.device_arms
        if n < self.min_device_batch or not avail:
            return "cpu"
        costs: dict[str, float] = {}
        for a in avail:
            d = self.expected_device_ms(n, a)
            if d is None:
                return a  # explore: one measurement teaches the model
            costs[a] = d
        cpu = self.expected_cpu_ms(n)
        if cpu is None:
            return "cpu"  # measure the CPU too
        best = min(costs, key=lambda a: costs[a])
        if costs[best] < cpu:
            return best
        if not count:
            return "cpu"
        # re-explore an arm within striking distance now and then, so a
        # stale loss can be unlearned
        for a in avail:
            if cpu * 4.0 < costs[a]:
                continue
            with self.lock:
                self._since[a] += 1
                if self._since[a] >= self.REEXPLORE_EVERY:
                    self._since[a] = 0
                    return a
        return "cpu"

    def use_device(self, n: int, count: bool = True) -> bool:
        return self.route(n, count=count) != "cpu"

    def get_json(self) -> dict:
        with self.lock:
            return {
                "cpu_persig_ms": self.cpu_persig_ms,
                "device_bucket_ms": dict(self._bucket_ms[self.device_arms[-1]]),
                "arms": {a: dict(b) for a, b in self._bucket_ms.items()},
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
        from ..crypto.backend import mesh_wants_width
        from .tracer import get_tracer

        if routing not in ("cost", "device"):
            raise ValueError(f"verify routing must be cost|device, got {routing!r}")
        self.tracer = tracer if tracer is not None else get_tracer()
        self.backend_name = backend
        # backend options flow to the factory verbatim (unknown keys
        # raise there)
        self.backend_opts = dict(backend_opts or {})
        self.verifier: BatchVerifier = make_verifier(backend, **self.backend_opts)
        # the one-card arm: when the wide verifier resolved to more than
        # one device, the same verifier is also built at width 1
        self._one_chip: Optional[BatchVerifier] = None
        if (mesh_wants_width(self.backend_opts.get("mesh"))
                and getattr(self.verifier, "n_devices", 1) > 1):
            self._one_chip = make_verifier(backend, **{**self.backend_opts, "mesh": "0"})
        self.cpu: BatchVerifier = (
            self.verifier if backend == "cpu" else make_verifier("cpu")
        )
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.min_device_batch = min_device_batch
        arms = ("dev1", "devN") if self._one_chip is not None else ("device",)
        self.model = _LatencyModel(min_device_batch, device_arms=arms)
        self._device_capable = backend != "cpu"
        self.routing = routing
        self._route_by_cost = routing == "cost"
        # device-wedge deadlines: the first device call may build the
        # kernel (nvcc), so it gets the generous one
        self._t_first, self._t_warm = resolve_timeouts(
            device_first_timeout, device_warm_timeout
        )
        self._warm_arms: set[str] = set()  # arms whose kernel has run
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
        # per-arm counters: which width the device traffic ran on
        self._arm_batches = dict.fromkeys(self.model.device_arms, 0)
        self._arm_sigs = dict.fromkeys(self.model.device_arms, 0)
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
                    or self.model.route(
                        max(len(self._pending), self.min_device_batch), count=False
                    ) != "cpu"
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

    def _verifier_of(self, arm: str) -> BatchVerifier:
        if arm == "dev1" and self._one_chip is not None:
            return self._one_chip
        return self.verifier

    def _device_deadline(self, n: int, arm: str) -> float:
        if arm not in self._warm_arms:
            return self._t_first
        hi = getattr(self._verifier_of(arm), "max_batch", self.max_batch)
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
                # every arm the router can pick (device routing picks
                # only the widest), widest first
                arms = self.model.device_arms
                for arm in reversed(arms if self._route_by_cost else arms[-1:]):
                    ver = self._verifier_of(arm)
                    for size in sizes:
                        reqs = [req] * size
                        for _ in range(max(2, rounds)):
                            t0 = time.perf_counter()
                            call_with_deadline(
                                lambda v=ver: v.verify_batch(reqs),
                                self._device_deadline(size, arm),
                                label="verify-prewarm",
                            )
                            self._warm_arms.add(arm)
                            self.model.observe_device(
                                size, (time.perf_counter() - t0) * 1000.0, arm=arm
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
        arm = "cpu"
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
                arm = self.model.route(n)
            elif n >= self.min_device_batch:
                arm = self.model.device_arms[-1]  # the widest arm
        if arm != "cpu":
            ver = self._verifier_of(arm)
            t0 = time.perf_counter()
            try:
                out = call_with_deadline(
                    lambda: ver.verify_batch(reqs),
                    self._device_deadline(n, arm),
                    label="verify-device",
                )
                t1 = time.perf_counter()
                ms = (t1 - t0) * 1000.0
                self._warm_arms.add(arm)
                self.model.observe_device(n, ms, arm=arm)
                self.device_batches += 1
                self.device_sigs += n
                self._arm_batches[arm] += 1
                self._arm_sigs[arm] += n
                self._hist["device"].record(ms)
                self.batches += 1
                self.verified += n
                self.tracer.complete("verify.batch", "verify", t0, t1, n=n,
                                     routed=arm)
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

    def _transfer_json(self) -> Optional[dict]:
        """Both device arms' transfer meters summed; None for a host
        backend."""
        agg = None
        for v in (self.verifier, self._one_chip):
            meter = getattr(v, "transfers", None) if v is not None else None
            if meter is None:
                continue
            j = meter.get_json()
            agg = j if agg is None else {k: agg.get(k, 0) + val for k, val in j.items()}
        return agg

    def get_json(self) -> dict:
        describe = getattr(self.verifier, "describe", None)
        return {
            "backend": self.backend_name,
            "routing": self.routing,
            # the wide verifier's devices, width and kernel
            "mesh": describe() if describe is not None else None,
            "transfers": self._transfer_json(),
            "arms": {a: {"batches": self._arm_batches[a], "sigs": self._arm_sigs[a]}
                     for a in self.model.device_arms},
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
