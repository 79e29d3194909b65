"""The scenario matrix as chip_smoke.py's scenarios phase holds it.

- ``test_port_matrix_gives_the_smoke_constants`` (tier 1): the port's
  run_simnet on every matrix scenario at the smoke's seed but
  ``flood_survival`` (40 s here; test_torch_simnet twin-runs its shape)
  and ``mesh_hash`` gives SCENARIO_CARDS' digest and hash.
- ``test_jax_smoke_constants`` (slow: every matrix scenario and corpus
  entry at full size through the JAX package, 8 host devices) prints
  and checks SCENARIO_CARDS, then runs the port's ``mesh_hash`` at full
  size on eight CPU shards (``devices=["cpu"] * 8``: its mesh leg's
  hasher at width 8 on K2's plain version, ~160 s here) and holds its
  scorecard to the JAX one and the constant:

      JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scenario_matrix.py -m slow -q -s

The tier-1 twin of a mesh scenario on eight CPU shards is
test_torch_search.py's sweep.
"""

from __future__ import annotations

import importlib

import pytest

import chip_smoke as cs
import stellard_tpu.testkit.scenarios as jax_scenarios
import stellard_tpu_torch.testkit.scenarios as port_scenarios
from test_torch_testkit import PACKAGES, recording_run_simnet

HEAVY = ("flood_survival", "mesh_hash")


def run_cards(pkg: str, names) -> dict:
    """name -> scorecard of each scenario through `pkg`'s run_simnet (the
    port's on eight CPU shards, the JAX one re-applying in the port's
    order), matrix scenarios at the smoke's seed."""
    scenarios = jax_scenarios if pkg == "jax" else port_scenarios
    runner = importlib.import_module(f"{PACKAGES[pkg]}.testkit.scenario")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        cards = recording_run_simnet(pkg, mp)
        for name in names:
            runner.run_simnet(scenarios.build_scenario(name, cs.SCENARIO_SEED))
            out[name] = cards[-1]
    return out


def test_port_matrix_gives_the_smoke_constants():
    names = [n for n in port_scenarios.MATRIX if n not in HEAVY]
    cards = run_cards("port", names)
    for name, card in cards.items():
        assert card["converged"] and card["single_hash"], name
        want_digest, want_hash = cs.SCENARIO_CARDS[name]
        assert card["final_hash"] == want_hash, name
        if name not in cs.SCENARIO_SAME_HASH:
            assert cs.scenario_digest(card) == want_digest, name
    for name, other in cs.SCENARIO_SAME_HASH.items():
        assert cards[name]["final_hash"] == cards[other]["final_hash"]


@pytest.mark.slow
def test_jax_smoke_constants():
    names = list(jax_scenarios.MATRIX) + list(jax_scenarios.load_corpus())
    cards = run_cards("jax", names)
    got = {name: (cs.scenario_digest(card), card["final_hash"]) for name, card in cards.items()}
    print("SCENARIO_CARDS = {")
    for name, (digest, final_hash) in got.items():
        print(f'    "{name}": (\n        "{digest}",\n        "{final_hash}"),')
    print("}")
    for name, card in cards.items():
        assert card["converged"] and card["single_hash"], name
    for name, other in cs.SCENARIO_SAME_HASH.items():
        assert got[name][1] == got[other][1]
    assert got == cs.SCENARIO_CARDS
    # the port's mesh leg at width 8 on eight CPU shards
    port_card = run_cards("port", ["mesh_hash"])["mesh_hash"]
    assert port_card == cards["mesh_hash"]
    assert port_card["mesh"] == {"width_requested": 8, "width": 8, "device_active": True,
                                 "wedged": False}
