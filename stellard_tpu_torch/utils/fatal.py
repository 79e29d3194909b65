"""Fatal-error reporting (reference: FatalErrorReporter + the
terminateHandler wiring at Application.cpp:645-653): uncaught exceptions
and hard faults are logged with full context before the process dies,
instead of vanishing into a bare traceback on a detached stderr."""

from __future__ import annotations

import faulthandler
import logging
import sys

_log = logging.getLogger("stellard.fatal")
_installed = False


def install() -> None:
    """Idempotently install the fault/exception reporters."""
    global _installed
    if _installed:
        return
    _installed = True
    # native-level faults (SIGSEGV/SIGABRT/...) dump all thread stacks
    try:
        faulthandler.enable()
    except (RuntimeError, AttributeError):  # no usable stderr (daemonized)
        pass
    previous = sys.excepthook

    def report(exc_type, exc, tb):
        _log.critical("FATAL: uncaught %s: %s", exc_type.__name__, exc,
                      exc_info=(exc_type, exc, tb))
        previous(exc_type, exc, tb)

    sys.excepthook = report

    # background threads bypass sys.excepthook — and that's where nearly
    # all of the node's runtime work happens (job workers, overlay
    # readers, watchdog)
    import threading

    prev_thread = threading.excepthook

    def thread_report(args):
        _log.critical(
            "FATAL in thread %s: uncaught %s: %s",
            args.thread.name if args.thread else "?",
            args.exc_type.__name__,
            args.exc_value,
            exc_info=(args.exc_type, args.exc_value, args.exc_traceback),
        )
        prev_thread(args)

    threading.excepthook = thread_report
