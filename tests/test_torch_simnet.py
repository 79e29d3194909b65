"""The port's simulated overlay and catch-up (overlay/simnet.py,
overlay/squelch.py, overlay/followertree.py, node/validator.py,
node/inbound.py, state/shamapsync.py) against the JAX package's.

Every test of tests/test_simnet.py and tests/test_sync.py, and every
case of tests/test_overlay_defense.py that does not need the TCP overlay
(its cases run in test_torch_tcp_defense.py), runs twice: once
as it is and once on its port twin (test_torch_consensus.port_twin).
Each run's assertions must hold, and what every SimNet and ValidatorNode
it made ended with (validated and closed hashes, the ledger index,
consensus_info, defense counters, net_stats, the accept log) must be
equal, as must every vote and quorum answer it asked for. The cases
that run the scenario kit (``SCENARIO_KIT``) go through
test_torch_testkit's harness: their scorecards are held equal too, and
the JAX run re-applies in the port's order (``jax_reapply_parity``).
"""

from __future__ import annotations

import pytest

import test_overlay_defense as tod
import test_simnet as tsn
import test_sync as tsy
from test_torch_consensus import cases, recorder, twin_runs  # noqa: F401
from test_torch_testkit import twin_scenario_runs

# the cases that open the TCP overlay (overlay/tcp.py), which
# test_torch_tcp_defense.py runs with a recorder for wall-clock nets
NOT_PORTED = ("TestSendqDiscipline", "TestTcpHostileFlood")
# the cases that run the scenario kit (testkit/scenario.py): twin-run by
# test_torch_testkit's harness, which also holds their scorecards equal
SCENARIO_KIT = ("TestFloodSurvival",
                "TestSimnetSquelch.test_squelched_vs_flooded_byte_identical_chain")


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(tsn))
def test_simnet_case_equal_to_jax(cname, mname, kwargs, recorder, tmp_path):  # noqa: F811
    twin_runs("test_simnet", cname, mname, kwargs, recorder, tmp_path)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(tsy))
def test_sync_case_equal_to_jax(cname, mname, kwargs, recorder, tmp_path):  # noqa: F811
    twin_runs("test_sync", cname, mname, kwargs, recorder, tmp_path)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(tod, skip=NOT_PORTED))
def test_overlay_defense_case_equal_to_jax(cname, mname, kwargs, recorder,  # noqa: F811
                                           tmp_path):
    if cname in SCENARIO_KIT or f"{cname}.{mname}" in SCENARIO_KIT:
        logs = twin_scenario_runs("test_overlay_defense", cname, mname, kwargs, recorder,
                                  tmp_path)
        assert logs["port"] == logs["jax"]
    else:
        twin_runs("test_overlay_defense", cname, mname, kwargs, recorder, tmp_path)
