"""The port's scenario runner over the real TCP net
(``testkit.tcpnet.run_tcp``): four ``python -m stellard_tpu_torch``
validator processes, a seeded kill/revive schedule and the scenario's
pre-signed workload submitted over the RPC doors.

- ``test_run_tcp_kill_revive_converges`` (tier 1, its own deadline): a
  data-form scenario of 16 steps, one kill at step 4 revived at 9, a
  payment flood of 12 on ``type=cpu`` crypto planes; the net converges
  on one hash, every transaction was submitted, and the run's walls
  (boot, the revive's door, steps, tail) and each validator's kernel
  counts are reported.
- ``test_run_tcp_without_a_card_raises``: ``backend="cuda"`` (the
  default) where no card is visible raises before any process starts.
- ``test_run_tcp_equal_to_jax`` (slow: two multi-process nets): the
  JAX ``run_tcp`` on the same scenario; the fault digest, the counts,
  the verdicts and the scorecard's keys are equal (the hashes follow
  the wall clock, run to run).
"""

from __future__ import annotations

import pytest

import stellard_tpu.testkit.scenario as jax_scenario
import stellard_tpu.testkit.schedule as jax_schedule
import stellard_tpu.testkit.tcpnet as jax_tcpnet
import stellard_tpu_torch.testkit.scenario as port_scenario
import stellard_tpu_torch.testkit.schedule as port_schedule
import stellard_tpu_torch.testkit.tcpnet as port_tcpnet
from test_torch_tcp import deadline

DEADLINE = 300


def small_scenario(scenario, schedule):
    sched = schedule.FaultSchedule(5)
    sched.kill(4, 2, revive_at=9)
    return scenario.Scenario(
        name="tcp_small", seed=5, n_validators=4, quorum=3, steps=16,
        schedule=sched, workload={"kind": "payment_flood", "n": 12},
        transports=("simnet", "tcp"))


def test_run_tcp_kill_revive_converges(tmp_path):
    scn = small_scenario(port_scenario, port_schedule)
    walls: dict = {}
    with deadline(DEADLINE):
        card = port_tcpnet.run_tcp(scn, backend="cpu", log_dir=str(tmp_path / "logs"),
                                   timeline=walls)
    assert card["converged"] and card["single_hash"], card
    assert card["kills"] == 1 and card["errors"] == 0
    # the master's funding of every account, then the flood of 12
    assert card["submitted"] == 12 + len(port_scenario.TxFactory(seed=5).fund_all())
    assert card["fault_digest"] == scn.schedule.digest()
    assert min(card["validated_seqs"]) >= card["final_seq"] >= 2
    assert walls["boot_s"] > 0 and walls["steps_s"] >= scn.steps * 1.0
    assert [r["validator"] for r in walls["revive_door_s"]] == [2]
    assert walls["revive_door_s"][0]["door_s"] > 0
    # a cpu net launches no kernel: each validator reports zero counts
    assert set(walls["kernels"]) == {"0", "1", "2", "3"}
    assert all(k is not None and not any(k.values()) for k in walls["kernels"].values())
    logs = sorted(p.name for p in (tmp_path / "logs").iterdir())
    assert logs == ["v0.log", "v1.log", "v2.log", "v3.log"]


def test_run_tcp_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the validators would run on it")
    scn = small_scenario(port_scenario, port_schedule)
    with pytest.raises(RuntimeError, match="cuda"):
        port_tcpnet.run_tcp(scn, log_dir=str(tmp_path / "logs"))
    assert not (tmp_path / "logs").exists()  # no process was started


def test_unsupported_fault_kinds_refused():
    """A partition cannot be expressed over real processes: both
    packages refuse the scenario before any process starts."""
    assert port_tcpnet.TCP_EVENT_KINDS == jax_tcpnet.TCP_EVENT_KINDS
    for scenario, schedule, run in (
            (jax_scenario, jax_schedule, jax_tcpnet.run_tcp),
            (port_scenario, port_schedule,
             lambda scn: port_tcpnet.run_tcp(scn, backend="cpu"))):
        scn = small_scenario(scenario, schedule)
        scn.schedule.partition(6, {0, 1}, {2, 3}, heal_at=8)
        with pytest.raises(ValueError, match="cannot express"):
            run(scn)


@pytest.mark.slow  # two multi-process nets, one after the other
def test_run_tcp_equal_to_jax():
    cards = {}
    with deadline(2 * DEADLINE):
        cards["jax"] = jax_tcpnet.run_tcp(small_scenario(jax_scenario, jax_schedule))
        cards["port"] = port_tcpnet.run_tcp(small_scenario(port_scenario, port_schedule),
                                            backend="cpu")
    for key in ("fault_digest", "submitted", "kills", "errors", "converged", "single_hash",
                "scenario", "seed", "transport", "steps"):
        assert cards["port"][key] == cards["jax"][key], key
    assert sorted(cards["port"]) == sorted(cards["jax"])
    assert cards["port"]["converged"] and cards["port"]["single_hash"]
