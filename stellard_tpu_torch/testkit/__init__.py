"""Adversarial scenario plane.

One scenario definition — validators, fault schedule, workload,
byzantine slots — drives TWO transports:

- the deterministic in-process simnet (``scenario.run_simnet``): seeded,
  discrete-time, bit-reproducible — the same seed replays the identical
  fault schedule and produces the identical per-scenario scorecard
  (FoundationDB's deterministic-simulation argument, SIGMOD 2021). Its
  mesh leg (``Scenario.mesh_width``) hashes on the card (K2), and
  ``run_simnet(device=, devices=)`` names the card or the CPU shards;
- the real TCP+TLS process net (``tcpnet.run_tcp``): wall-clock, kill -9
  real processes — the same scenario shape under genuine sockets and
  schedulers, each validator a ``python -m stellard_tpu_torch`` process
  on ``backend="cuda"`` (or ``"cpu"``).

``search`` is the coverage-guided sweep and shrinker over the simnet,
``scenarios`` the matrix and the minimal-repro corpus (``corpus/``),
``byzantine`` the hostile validator and relay-peer slots, ``schedule``
the fault DSL and ``workloads`` the hostile workload generators.

Yuan et al. (OSDI 2014) found most catastrophic distributed-system
failures hide in untested error-handling paths reachable by SIMPLE fault
injection; this package makes those paths a regression-gated surface
instead of a soak-day anecdote.
"""

from .schedule import FaultSchedule
from .scenario import Scenario, run_simnet
from .scenarios import MATRIX, build_scenario, corpus_scenarios, load_corpus

__all__ = [
    "FaultSchedule",
    "Scenario",
    "run_simnet",
    "MATRIX",
    "build_scenario",
    "load_corpus",
    "corpus_scenarios",
]
