"""The port's scenario search (testkit/search.py) and corpus
(testkit/corpus/) against the JAX package's.

- **Twins.** Every test of tests/test_search.py runs twice, as it is
  and on its port twin, through test_torch_testkit's harness: each
  run's assertions hold, and every scorecard the runs made, and what
  every SimNet and ValidatorNode ended with, are equal.
  ``TestCrossProcessDeterminism`` stays slow, as its original is.
- **Generation.** ``ScenarioGenerator``'s fresh scenarios and mutation
  streams are the same data (``Scenario.digest``) in both packages on
  fuzz seeds 0-15, with and without the planted bug's fault kind.
- **A sweep** with a generated mesh scenario: test_torch_search_sweep.py.
- **The corpus.** The port's corpus directory is the JAX one, byte for
  byte, and each entry replays clean in both packages with equal
  scorecards.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import stellard_tpu.testkit.scenarios as jax_scenarios
import stellard_tpu.testkit.search as jax_search
import stellard_tpu_torch.testkit.scenarios as port_scenarios
import stellard_tpu_torch.testkit.search as port_search
import test_search as jts
from test_torch_consensus import cases, port_twin, recorder  # noqa: F401
from test_torch_testkit import recording_run_simnet, twin_scenario_runs

SLOW = ("TestCrossProcessDeterminism",)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(jts, skip=SLOW))
def test_search_case_equal_to_jax(cname, mname, kwargs, recorder, tmp_path):  # noqa: F811
    logs = twin_scenario_runs("test_search", cname, mname, kwargs, recorder, tmp_path)
    assert logs["port"] == logs["jax"]


@pytest.mark.slow  # as its original: two processes, each a sweep and a shrink
def test_cross_process_determinism_port_twin():
    """TestCrossProcessDeterminism on the port: the driver's sweep and
    shrink with PYTHONHASHSEED 1 and 31337 give the same output. Its
    driver names the CPU shards (a process of its own cannot be
    patched), and the two packages' outputs are equal."""
    twin = port_twin("test_search")
    cpu = "device='cpu', devices=['cpu'] * 8"
    driver = twin._XPROC_DRIVER
    for call in ("determinism_check=False)", "max_runs=40\n)"):
        assert driver.count(call) == 1
        driver = driver.replace(call, call[:-1].rstrip() + f", {cpu})")
    # the JAX driver re-applies in the port's order (jax_reapply_parity)
    parity = ("import pytest\n"
              f"sys.path.insert(0, {str(Path(__file__).parent)!r})\n"
              "from test_torch_testkit import jax_reapply_parity\n"
              "jax_reapply_parity(pytest.MonkeyPatch())\n")
    first, rest = jts._XPROC_DRIVER.split("\n# (a)", 1)
    outs = {}
    for pkg, src in (("jax", f"{first}\n{parity}# (a){rest}"), ("port", driver)):
        got = []
        for hashseed in ("1", "31337"):
            env = dict(os.environ, PYTHONHASHSEED=hashseed, JAX_PLATFORMS="cpu")
            r = subprocess.run([sys.executable, "-c", src.replace("@@REPO@@", repr(jts.REPO))],
                               capture_output=True, text=True, timeout=600, env=env,
                               cwd=jts.REPO)
            assert r.returncode == 0, r.stderr[-2000:]
            got.append(r.stdout.strip().splitlines()[-1])
        assert got[0] == got[1], pkg
        outs[pkg] = got[0]
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("allow_synth", [False, True])
def test_generator_streams_equal_to_jax(allow_synth):
    """Fuzz seeds 0-15: six fresh scenarios, then four mutations of each
    of the first two, the same data in both packages."""
    for seed in range(16):
        gens = (jax_search.ScenarioGenerator(seed, allow_synth=allow_synth),
                port_search.ScenarioGenerator(seed, allow_synth=allow_synth))
        streams = []
        for gen in gens:
            fresh = [gen.fresh() for _ in range(6)]
            mutated = [gen.mutate(p) for p in fresh[:2] for _ in range(4)]
            streams.append([s.digest() for s in fresh + mutated])
        assert streams[1] == streams[0], seed


def test_corpus_directory_equal_to_jax():
    ours, theirs = Path(port_scenarios.CORPUS_DIR), Path(jax_scenarios.CORPUS_DIR)
    assert ours != theirs
    names = sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names and len(names) >= 5
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    assert port_scenarios.load_corpus() == jax_scenarios.load_corpus()


@pytest.mark.parametrize("name", sorted(jax_scenarios.load_corpus()))
def test_corpus_entry_replays_clean_equal_to_jax(name):
    """Each corpus entry, at its own seed, through both packages'
    run_simnet: no invariant fires, and the scorecards are equal."""
    runs = {}
    for pkg, kit in (("jax", (jax_scenarios, jax_search)),
                     ("port", (port_scenarios, port_search))):
        scenarios, search = kit
        with pytest.MonkeyPatch.context() as mp:
            cards = recording_run_simnet(pkg, mp)
            scn = scenarios.build_scenario(name)
            card = search.run_simnet(scn)
            assert search.check_invariants(scn, card) == [], (pkg, name)
            assert card["converged"] and card["single_hash"]
        runs[pkg] = cards
    assert runs["port"] == runs["jax"]
    assert json.dumps(runs["port"], sort_keys=True) == json.dumps(runs["jax"], sort_keys=True)
