"""Node runtime: config, typed async executor, ledger chain state
machine, network operations brain, and the application container.

Reference layers L5/L8/L10 (SURVEY §1): src/ripple_core/functional,
src/ripple_app/misc/NetworkOPs.cpp, src/ripple_app/main/Application.cpp.

The names below load on first use, so that importing a torch-free
submodule (``node.metrics``, ``node.tracer``, which the speculation
pool's workers run) does not import the crypto planes and ``torch``.
"""

import importlib

_EXPORTS = {
    "Config": "config",
    "Job": "jobqueue",
    "JobQueue": "jobqueue",
    "JobType": "jobqueue",
    "HashRouter": "hashrouter",
    "SF_BAD": "hashrouter",
    "SF_RELAYED": "hashrouter",
    "SF_SAVED": "hashrouter",
    "SF_SIGGOOD": "hashrouter",
    "SF_TRUSTED": "hashrouter",
    "VerifyPlane": "verifyplane",
    "LedgerMaster": "ledgermaster",
    "NetworkOPs": "networkops",
    "OperatingMode": "networkops",
    "Node": "node",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    globals()[name] = value
    return value
