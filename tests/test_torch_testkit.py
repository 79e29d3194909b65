"""The port's scenario kit (testkit/byzantine.py, testkit/scenario.py,
testkit/scenarios.py and the fault DSL beneath them) against the JAX
package's.

Every test of tests/test_testkit.py runs twice: once as it is and once
on its port twin (test_torch_consensus.port_twin: its source with
``stellard_tpu.`` read as ``stellard_tpu_torch.``). Each run's
assertions must hold, and what it made must be equal, with zero
tolerance:

- every scorecard each package's ``run_simnet`` returned, in order
  (less the wall-clock ``spec`` block, as search._strip_nondeterministic
  leaves it out);
- what every SimNet and ValidatorNode ended with, and every vote and
  quorum answer (test_torch_consensus's recorder).

The port's ``run_simnet`` takes ``device=``/``devices=`` for its mesh
leg and defaults to the card; the twin runs it on eight CPU shards
(``CPU_SHARDS``), as the JAX tests see eight host devices. The JAX run
goes through ``jax_reapply_parity``: the JAX package re-applies a
close's leftovers and a round's lost disputes in tx-map and dispute
order, the port in canonical order (ROADMAP Queue C), which
moves what each open ledger speculates and so the scorecard's
``splice`` counts, though not a hash; the switch gives the JAX run the
port's order, as ``test_torch_resume.jax_lazy_parity`` switches off the
JAX package's lazy-tree faults.
"""

from __future__ import annotations

import importlib
import inspect
import textwrap

import pytest

import test_testkit as jtk
from test_torch_consensus import cases, port_twin, recorder  # noqa: F401
from test_torch_txq import run_method

# the devices a port twin's mesh leg is cut from: eight CPU shards
CPU_SHARDS = ["cpu"] * 8
PACKAGES = {"jax": "stellard_tpu", "port": "stellard_tpu_torch"}


def jax_reapply_parity(mp) -> None:
    """The JAX package's close and round re-applying in the port's order:
    ``LedgerMaster._open_next``'s leftovers and ``LedgerConsensus.accept``'s
    lost disputes each through a ``CanonicalTXSet`` salted by the new
    ledger's hash (each account's transactions by sequence), as the
    port's ``close_with_txset`` and ``accept`` take them."""
    import stellard_tpu.consensus.consensus as jc
    import stellard_tpu.node.ledgermaster as jlm
    from stellard_tpu.protocol.sttx import SerializedTransaction

    open_next = jlm.LedgerMaster._open_next

    def canonical_open_next(self, new_lcl, apply_ms, leftovers=()):
        txset = jlm.CanonicalTXSet(new_lcl.hash())
        for tx in leftovers:
            txset.insert(tx)
        return open_next(self, new_lcl, apply_ms,
                         leftovers=[tx for _k, tx in txset.items_sorted()])

    def canonical_disputes(disputes, skip, new_lcl) -> list:
        txset = jlm.CanonicalTXSet(new_lcl.hash())
        of = {}
        for d in disputes.values():
            if d.txid not in skip and d.blob:
                tx = SerializedTransaction.from_bytes(d.blob)
                txset.insert(tx)
                of[tx.txid()] = d
        return [of[tx.txid()] for _k, tx in txset.items_sorted()]

    # accept's re-apply loop, the one place it walks the disputes in
    # dict order, reads them through canonical_disputes
    src = textwrap.dedent(inspect.getsource(jc.LedgerConsensus.accept))
    loop = "    for d in self.disputes.values():\n        if d.txid not in skip and d.blob:"
    assert src.count(loop) == 1, "JAX LedgerConsensus.accept changed"
    ns = dict(vars(jc), _canonical_disputes=canonical_disputes)
    exec(compile(src.replace(loop, loop.replace(
        "self.disputes.values()", "_canonical_disputes(self.disputes, skip, new_lcl)")),
        jc.__file__, "exec"), ns)
    mp.setattr(jlm.LedgerMaster, "_open_next", canonical_open_next)
    mp.setattr(jc.LedgerConsensus, "accept", ns["accept"])


def plain_card(card: dict) -> dict:
    """A scorecard as the twins compare it: without the wall-clock spec
    pool's counters."""
    return {k: v for k, v in card.items() if k != "spec"}


def recording_run_simnet(pkg: str, mp, mod=None) -> list:
    """Route every call of `pkg`'s ``run_simnet`` — the test module's
    name, the kit's, and the search plane's defaults — through one that
    records its scorecard (the port's on CPU_SHARDS); -> the list the
    scorecards go to."""
    root = PACKAGES[pkg]
    scenario = importlib.import_module(f"{root}.testkit.scenario")
    search = importlib.import_module(f"{root}.testkit.search")
    kit = importlib.import_module(f"{root}.testkit")
    real = scenario.run_simnet
    cards: list = []

    def run(scn, tmpdir=None, **_device):
        if pkg == "port":
            card = real(scn, tmpdir, device="cpu", devices=CPU_SHARDS)
        else:
            card = real(scn, tmpdir)
        cards.append(plain_card(card))
        return card

    for m in (scenario, search, kit, mod):
        if m is not None and getattr(m, "run_simnet", None) is real:
            mp.setattr(m, "run_simnet", run)
    # the JAX search plane binds run_simnet as a default argument
    for name in ("shrink_scenario", "sweep", "coverage_comparison"):
        fn = getattr(search, name)
        if fn.__defaults__ and real in fn.__defaults__:
            mp.setattr(fn, "__defaults__",
                       tuple(run if d is real else d for d in fn.__defaults__))
    if pkg == "jax":
        jax_reapply_parity(mp)
    return cards


def twin_scenario_runs(name: str, cname: str, mname: str, kwargs: dict, recorder,  # noqa: F811
                       tmp_path) -> dict:
    """tests/<name>.py's case run as it is and on its port twin; both must
    pass. -> {pkg: (scorecards, recorded objects)}."""
    logs = {}
    for pkg, mod in (("jax", importlib.import_module(name)), ("port", port_twin(name))):
        path = tmp_path / pkg
        path.mkdir()
        recorder.watch(pkg)
        try:
            with pytest.MonkeyPatch.context() as mp:
                cards = recording_run_simnet(pkg, mp, mod)
                run_method(mod, getattr(mod, cname), mname, tmp_path=path, kwargs=kwargs)
        finally:
            logs[pkg] = (cards, recorder.take())
    return logs


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(jtk))
def test_testkit_case_equal_to_jax(cname, mname, kwargs, recorder, tmp_path):  # noqa: F811
    logs = twin_scenario_runs("test_testkit", cname, mname, kwargs, recorder, tmp_path)
    assert logs["port"] == logs["jax"]


def test_every_matrix_scenario_builds_the_same_data():
    """Each matrix builder of both packages, at seeds 0 and 7: the same
    scenario as data (``Scenario.digest``), its fault schedule's digest
    and the knobs the runner reads."""
    import stellard_tpu.testkit.scenarios as js
    import stellard_tpu_torch.testkit.scenarios as ps

    assert list(ps.MATRIX) == list(js.MATRIX)
    for name in js.MATRIX:
        for seed in (0, 7):
            a, b = js.build_scenario(name, seed), ps.build_scenario(name, seed)
            assert b.digest() == a.digest(), name
            assert b.to_json() == a.to_json(), name


def test_byzantine_behaviours_equal_to_jax():
    import stellard_tpu.testkit.byzantine as jb
    import stellard_tpu_torch.testkit.byzantine as pb

    assert pb.BEHAVIORS == jb.BEHAVIORS
    assert pb.FLOOD_BEHAVIORS == jb.FLOOD_BEHAVIORS


def test_mesh_leg_without_a_card_raises():
    """``run_simnet``'s mesh leg on the card (its default) where no card
    is visible raises before the net is built; nothing hashes on the
    host in its place."""
    import torch

    from stellard_tpu_torch.testkit.scenarios import build_scenario
    from stellard_tpu_torch.testkit.scenario import run_simnet

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the mesh leg would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        run_simnet(build_scenario("mesh_hash", seed=7))


def test_reapply_order_moves_only_the_splice_counts():
    """The one difference the twins switch off (ROADMAP Queue C): the JAX
    package as it is re-applies leftovers and lost disputes in map
    order, the port in canonical order. On ``byzantine`` at seed 7 that
    changes which transactions each open ledger speculates, so the
    scorecards differ in their ``splice`` counts alone; the chain, every
    other count and every verdict are the same."""
    from stellard_tpu.testkit.scenario import run_simnet as jax_run
    from stellard_tpu.testkit.scenarios import build_scenario as jax_build
    from stellard_tpu_torch.testkit.scenario import run_simnet as port_run
    from stellard_tpu_torch.testkit.scenarios import build_scenario as port_build

    jax_card = jax_run(jax_build("byzantine", 7))
    port_card = port_run(port_build("byzantine", 7))
    assert {k for k in jax_card if jax_card[k] != port_card[k]} == {"splice"}
    assert jax_card["splice"] == {"closes": 30, "spliced": 78, "fallback": 69, "invalidated": 69}
    assert port_card["splice"] == {"closes": 30, "spliced": 90, "fallback": 57,
                                   "invalidated": 57}
    with pytest.MonkeyPatch.context() as mp:
        jax_reapply_parity(mp)
        assert jax_run(jax_build("byzantine", 7)) == port_card
