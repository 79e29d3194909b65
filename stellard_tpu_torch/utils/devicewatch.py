"""Device-call watchdog: run accelerator calls on a sacrificial thread.

A device call that never returns (a hung CUDA call, a kernel that does not
terminate) must not freeze a validator mid-consensus: the call fails
instead, and the fault is reported loudly (the reference's LoadManager
deadlock-detector role, src/ripple_core/functional/LoadManager.cpp:180-214).
Nothing moves to the host: a wedged card fails the closes and the
verifications that need it until the node is restarted.

``call_with_deadline`` runs ``fn`` on a daemon thread and waits up to
``timeout_s``. On timeout the thread is abandoned (the leaked thread is
daemon and holds no locks of ours) and ``DeviceWedged`` raises.
``DeviceHealth`` records a permanent verdict so every later device call
raises at once — one wedge fails every device plane for the life of the
process; a restart is the recovery path.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable

log = logging.getLogger("stellard.device")


class DeviceWedged(RuntimeError):
    """A device call exceeded its deadline (a hung CUDA call or kernel)."""


def resolve_timeouts(
    first: float | None, warm: float | None
) -> tuple[float, float]:
    """Shared env-backed deadline resolution for every device plane:
    (first-call/compile deadline, warmed-call deadline) in seconds."""
    import os

    if first is None:
        first = float(os.environ.get("STELLARD_DEVICE_FIRST_TIMEOUT_S", "900"))
    if warm is None:
        warm = float(os.environ.get("STELLARD_DEVICE_WARM_TIMEOUT_S", "60"))
    return first, warm


class DeviceHealth:
    """Process-wide device liveness verdict (sticky once dead)."""

    def __init__(self) -> None:
        self._dead = threading.Event()
        self.reason = ""

    @property
    def dead(self) -> bool:
        return self._dead.is_set()

    def mark_dead(self, reason: str) -> None:
        if not self._dead.is_set():
            self.reason = reason
            self._dead.set()
            log.error("device plane marked DEAD: %s — all device work "
                      "now fails for the life of this process", reason)

    def reset(self) -> None:
        """Test seam."""
        self._dead = threading.Event()
        self.reason = ""


# one verdict per process: a wedged device wedges every device plane
HEALTH = DeviceHealth()

# every call_with_deadline pays for a thread start: the calls made and
# the ms from the start request to the call running on its thread
_CALLS_LOCK = threading.Lock()
call_stats = {"calls": 0, "start_ms": 0.0}


def _note_call(start_ms: float) -> None:
    with _CALLS_LOCK:
        call_stats["calls"] += 1
        call_stats["start_ms"] += start_ms


def reset_call_stats() -> None:
    with _CALLS_LOCK:
        call_stats["calls"] = 0
        call_stats["start_ms"] = 0.0


def call_with_deadline(
    fn: Callable[[], Any],
    timeout_s: float,
    *,
    label: str = "device",
    health: DeviceHealth = HEALTH,
) -> Any:
    """Run ``fn()`` under ``timeout_s``; raise DeviceWedged on overrun.

    A timeout marks ``health`` dead (sticky). Exceptions from ``fn``
    propagate unchanged.
    """
    if health.dead:
        raise DeviceWedged(health.reason)
    box: dict[str, Any] = {}
    done = threading.Event()
    t_start = time.perf_counter()

    def run() -> None:
        _note_call((time.perf_counter() - t_start) * 1e3)
        try:
            box["r"] = fn()
        except BaseException as exc:  # noqa: BLE001 — relayed to caller
            box["e"] = exc
        finally:
            done.set()

    caller = threading.current_thread()
    t = threading.Thread(target=run, daemon=True, name=f"{label}-call")
    # device work done on this thread is counted under the role of the
    # thread that asked for it (ops.treehash.launches_by_thread)
    t.role = getattr(caller, "role", caller.name)
    t.start()
    if not done.wait(timeout_s):
        health.mark_dead(
            f"{label} call exceeded {timeout_s:.0f}s (wedged device?)"
        )
        raise DeviceWedged(health.reason)
    if "e" in box:
        raise box["e"]
    return box["r"]
