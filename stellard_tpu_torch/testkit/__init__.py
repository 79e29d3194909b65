"""Test kit: the fault-schedule DSL (``schedule.py``), hostile workload
generators (``workloads.py``) and the real-process TCP net helpers
(``tcpnet.py``).

The scenario plane that drives one scenario over the in-process simnet
and the TCP process net (``scenario``, ``scenarios``, ``search``,
``byzantine``) is not part of this package yet.
"""

from .schedule import FaultSchedule

__all__ = ["FaultSchedule"]
