"""The out-of-core slice as a whole: a lazily resumed node of each package.

A small chain (a few hundred AccountRoots, chip_smoke.close_workload's
payments through the doors, every closed ledger persisted through the
node's close pipeline into an on-disk segstore, txdb and CLF) is built
and saved by each package's Node (tests/test_torch_close.py's
run_node_closes: the JAX node on its host planes, the port's with its
CudaHasher's plain K2/K3 on the CPU). Each is then restarted with
``[start_up] load`` (chip_smoke.RESUME_CONFIG, the path plane off) — the
resume reads the header and the two roots,
every other node faults on demand — and driven as chip_smoke.py's
resume step drives the card's (chip_smoke.drive_resume): account_info
at the resumed ledger and at a historical one (a cold, lazy load), 32
payments through `submit`, one `ledger_accept`, the save into the same
store. The resumed and closed hashes, the results, the read answers
and the nodes the save wrote must be equal, with zero tolerance; no
node may be faulted inside a seal, and the port's hasher must hash on
the host only what K2/K3 cannot take.

The nodes faulted (by stage) and the store fetches at boot are held to
the JAX node's with two faults of the reference switched off in its run
(jax_lazy_parity; ROADMAP Queue C): its ``Ledger.__init__`` tests the
loaded trees' truth (``tx_map or SHAMap(...)``), which calls
``SHAMap.__len__`` and faults every node of a lazy load; and its native
merge, given a tree built without its source (the delta replay's
building tree), fails on the first stub, so the close absorbs a fold
error. As it is, the JAX node faults its whole state at boot.

Then the two node paths the smoke does not drive, on both packages: the
history fallback (a closed ledger outside the cache, rebuilt lazily
from the store) and the resume from the txdb's newest header when the
CLF holds no pointer.
"""

from __future__ import annotations

import importlib
import shutil

import pytest

import chip_smoke as cs
import test_torch_close as ttc

SIZES = dict(n_accounts=300, n_senders=48, n_closes=3, per_close=48, seed=17)
RESUME = dict(payments=32, reads=16, history_reads=8, seed=19)
HISTORY_SEQ = cs.START_SEQ + 1
EXTRA = {"stellard_tpu": ttc.JAX_NODE, "stellard_tpu_torch": ttc.PORT_NODE_CPU}


def jax_lazy_parity(mp) -> None:
    """The JAX package's run without its two lazy-tree faults: a SHAMap
    is true whatever its size (the port's ``is None`` tests), and
    bulk_update takes the Python merge (test_ooc_state.py's own switch)."""
    import stellard_tpu.state.shamap as jax_shamap

    mp.setattr(jax_shamap.SHAMap, "__bool__", lambda self: True, raising=False)
    mp.setattr(jax_shamap, "_native_merge", None)
    mp.setattr(jax_shamap, "_native_resolved", True)


def names(root: str):
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return mod("node.node").Node, mod("node.config").Config, mod("state.shamap")


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Each package's chain, built and saved by its node, the node
    stopped and its CLF closed: -> {root: (store dir, workload)}."""
    wl = cs.close_workload(**SIZES)
    out = {}
    for root in EXTRA:
        store = tmp_path_factory.mktemp(root.replace("_", "")) / "store"
        res = ttc.run_node_closes(root, wl, store, EXTRA[root])
        res["node"].clf.db.close()
        out[root] = store
    return out, wl


def copy_of(chains, root: str, tmp_path):
    stores, wl = chains
    dst = tmp_path / root
    shutil.copytree(stores[root], dst)
    return dst, wl


def config_text(root: str, store) -> str:
    return cs.node_config_text(store, EXTRA[root].format(floor=cs.BOOK_PRUNE_FLOOR)
                               + cs.RESUME_CONFIG)


def resume_and_close(root: str, store, wl) -> dict:
    res = ttc.run_resume(root, store, EXTRA[root], wl, 0, SIZES["n_closes"], HISTORY_SEQ,
                         RESUME)
    for k in ("reads_ms", "history_reads_ms", "submits_ms", "ledger_accept_ms", "persist_ms"):
        res.pop(k)
    boot = res.pop("boot")
    return {"boot": {k: boot[k] for k in ("fetches", "faults")}, "lazy": res.pop("lazy"),
            "trees": res.pop("trees"), "entries": res.pop("entries"), "res": res}


@pytest.fixture(scope="module")
def resumed(chains, tmp_path_factory):
    """The resumed close of the port, of the JAX package as it is and of
    the JAX package under jax_lazy_parity."""
    out = {}
    for run, root in (("port", "stellard_tpu_torch"), ("jax", "stellard_tpu"),
                      ("jax_parity", "stellard_tpu")):
        store, wl = copy_of(chains, root, tmp_path_factory.mktemp(run))
        with pytest.MonkeyPatch.context() as mp:
            if run == "jax_parity":
                jax_lazy_parity(mp)
            out[run] = resume_and_close(root, store, wl)
    return out


def without_faults(res: dict) -> dict:
    return {k: v for k, v in res.items() if k not in ("faults", "seal_faults")}


def test_a_lazy_resume_reads_the_header_and_two_roots(resumed):
    for run in ("port", "jax_parity"):
        assert resumed[run]["lazy"], run
        assert resumed[run]["boot"] == {"fetches": 3, "faults": 2}, (run, resumed[run]["boot"])
    # the JAX package as it is: its Ledger.__init__ walks both lazy trees
    jax = resumed["jax"]["boot"]
    assert jax["faults"] > SIZES["n_accounts"] and jax["fetches"] == jax["faults"] + 1


def test_the_resumed_close_equals_the_jax_node(resumed):
    port = resumed["port"]
    assert without_faults(port["res"]) == without_faults(resumed["jax"]["res"])
    assert port["res"] == resumed["jax_parity"]["res"]
    res = port["res"]
    assert res["resumed"][0] == cs.START_SEQ + SIZES["n_closes"]
    assert res["seq"] == res["resumed"][0] + 1
    assert not res["read_errors"]
    good = sum(g for _b, _k, g in port["entries"])
    assert len(res["close_ters"]) == good and set(res["close_ters"].values()) == {0}
    assert res["nodes"] > 1


def test_the_resumed_node_faults_but_never_in_a_seal(resumed):
    for run in ("port", "jax_parity"):
        faults = resumed[run]["res"]["faults"]
        assert faults.get("reads", 0) > 0 and faults.get("history", 0) > 0, (run, faults)
        assert faults.get("submits", 0) + faults.get("close", 0) > 0, (run, faults)
    for run, r in resumed.items():
        assert r["res"]["seal_faults"] == 0, run
    trees = resumed["port"]["trees"]
    assert trees and all(host == only for host, only in trees), trees


# -- the node paths the smoke does not drive ----------------------------------


@pytest.fixture()
def lazy_parity(monkeypatch):
    """An empty hot-node cache in both packages, and the JAX package
    under jax_lazy_parity (as it is, its loads walk the whole tree)."""
    for root in EXTRA:
        names(root)[2].inner_node_cache().clear()
    jax_lazy_parity(monkeypatch)


@pytest.mark.parametrize("root", sorted(EXTRA))
def test_history_fallback_loads_lazily(chains, root, tmp_path, lazy_parity):
    """A closed ledger outside the resumed node's cache comes back from
    the store through the history fallback as a lazy ledger: its hash
    from the header and two roots, its state faulted on demand."""
    store, _wl = copy_of(chains, root, tmp_path)
    Node, Config, shamap = names(root)
    node, _boot = cs.boot_resumed(Node, Config, config_text(root, store))
    try:
        hdr = node.txdb.get_ledger_header(seq=HISTORY_SEQ)
        lm = node.ledger_master
        assert lm.get_ledger_by_seq(HISTORY_SEQ) is None
        fetches0 = node.nodestore.get_json()["backend_fetches"]
        led = lm.get_ledger_by_hash(hdr["hash"])
        fetched = node.nodestore.get_json()["backend_fetches"] - fetches0
        assert led.hash() == hdr["hash"] and led.seq == HISTORY_SEQ
        assert led.state_map._source is not None and fetched <= 3
        assert len(list(led.state_map.items())) > SIZES["n_accounts"]
    finally:
        node.stop()


@pytest.mark.parametrize("root", sorted(EXTRA))
def test_resume_from_the_txdb_header_without_a_clf_pointer(chains, root, tmp_path,
                                                          lazy_parity):
    """With no CLF state (its file gone), ``[start_up] load`` resumes
    lazily from the txdb's newest ledger header: the chain's last
    closed ledger, read from its header and two roots."""
    store, _wl = copy_of(chains, root, tmp_path)
    for p in store.glob("txdb.db.clf*"):
        p.unlink()
    Node, Config, _shamap = names(root)
    node, boot = cs.boot_resumed(Node, Config, config_text(root, store))
    try:
        hdr = node.txdb.get_ledger_header()
        led = node.ledger_master.closed_ledger()
        assert node.clf.last_closed_hash is None
        assert (led.seq, led.hash()) == (cs.START_SEQ + SIZES["n_closes"], hdr["hash"])
        assert led.state_map._source is not None and boot["fetches"] == 3
    finally:
        node.stop()
