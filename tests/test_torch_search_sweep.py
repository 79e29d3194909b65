"""One coverage sweep of the port's search plane (testkit/search.py)
against the JAX package's, with a generated mesh scenario.

A uniform sweep with ``SYNTH_BUG`` armed, on a fuzz seed whose first
scenario has a mesh leg (width 2; the port's on eight CPU shards, the
JAX one's on eight host devices) and whose second trips the planted
bug: the returned coverage map, scenario digests, violations, shrunk
scenarios and shrink trajectories are equal, as is every scorecard the
two sweeps made (test_torch_testkit's harness). The port's mesh leg
runs K2's plain version, about two and a half minutes here: the test
has a file of its own so that it runs beside test_torch_search.py.
"""

from __future__ import annotations

import pytest

import stellard_tpu.testkit.search as jax_search
import stellard_tpu_torch.testkit.search as port_search
from test_torch_testkit import recording_run_simnet

# a fuzz seed whose first generated scenario has a mesh leg (width 2) and
# a planted bug below the threshold, and whose second trips it
SWEEP_SEED = 246


def test_sweep_with_a_mesh_scenario_equal_to_jax():
    runs = {}
    for pkg, search in (("jax", jax_search), ("port", port_search)):
        with pytest.MonkeyPatch.context() as mp:
            cards = recording_run_simnet(pkg, mp)
            res = search.sweep(SWEEP_SEED, 2, guided=False, allow_synth=True, shrink=True,
                               determinism_check=False, max_shrink_runs=20)
        runs[pkg] = (res, cards)
    res, cards = runs["port"]
    assert runs["port"] == runs["jax"]
    # the sweep's first scenario ran the mesh leg on two of the shards, on
    # the kernel's plain version; the second was shrunk to the planted
    # bug's known minimum
    mesh = cards[0]["mesh"]
    assert mesh == {"width_requested": 2, "width": 2, "device_active": True,
                    "wedged": False}
    shrunk = [v for v in res["violations"] if "shrunk" in v]
    assert [v["invariant"] for v in shrunk] == ["synthetic_bug"]
    assert shrunk[0]["shrink_trajectory"]
    events = shrunk[0]["shrunk"]["schedule"]["events"]
    assert sorted(e[2] for e in events) == ["synth_plant", "synth_plant"]
    assert sum(e[3][0] for e in events) == port_search.SYNTH_THRESHOLD
