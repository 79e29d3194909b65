"""Node runtime: config, typed async executor, ledger chain state
machine, network operations brain, and the application container.

Reference layers L5/L8/L10 (SURVEY §1): src/ripple_core/functional,
src/ripple_app/misc/NetworkOPs.cpp, src/ripple_app/main/Application.cpp.
"""

from .config import Config
from .jobqueue import Job, JobQueue, JobType
from .hashrouter import HashRouter, SF_BAD, SF_RELAYED, SF_SAVED, SF_SIGGOOD, SF_TRUSTED
from .verifyplane import VerifyPlane
from .ledgermaster import LedgerMaster
from .networkops import NetworkOPs, OperatingMode
from .node import Node

__all__ = [
    "Config",
    "Job",
    "JobQueue",
    "JobType",
    "HashRouter",
    "SF_BAD",
    "SF_RELAYED",
    "SF_SAVED",
    "SF_SIGGOOD",
    "SF_TRUSTED",
    "VerifyPlane",
    "LedgerMaster",
    "NetworkOPs",
    "OperatingMode",
    "Node",
]
