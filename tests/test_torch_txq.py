"""The port's admission queue (node/txq.py, its LedgerMaster and NetworkOPs
wiring, LoadFeeTrack, LocalTxs) against the JAX package's.

Every test of tests/test_txq.py runs twice here, in one test: once as it
is (the JAX package), once with the port's names in its module's place
(the port's Node on cpu crypto planes, TxQ, FeeMetrics, LoadFeeTrack,
LocalTxs, protocol types and RPC dispatch). Each run's assertions must
hold, and each run records, for every node the test makes, every
submit's (txid, TER, applied) and every close's (sequence, ledger hash,
per-transaction TERs): the two records must be equal. The tolerance is
zero, since these are bytes.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass

import pytest

import stellard_tpu.node.networkops as jax_netops
import stellard_tpu.protocol.sfields as jax_sfields
import test_txq as tq
from stellard_tpu_torch.node import ledgermaster as port_lm_mod
from stellard_tpu_torch.node.config import Config as PortConfig
from stellard_tpu_torch.node.loadmgr import NORMAL_FEE, LoadFeeTrack
from stellard_tpu_torch.node.localtxs import LocalTxs
from stellard_tpu_torch.node.networkops import TxStatus
from stellard_tpu_torch.node.node import Node
from stellard_tpu_torch.node.txq import NORMAL_LEVEL, FeeMetrics, fee_level
from stellard_tpu_torch.protocol import sfields as port_sfields
from stellard_tpu_torch.protocol.formats import TxType
from stellard_tpu_torch.protocol.keys import KeyPair
from stellard_tpu_torch.protocol.stamount import STAmount
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.protocol.ter import TER
from stellard_tpu_torch.rpc.handlers import Context, Role, dispatch


@dataclass
class CpuConfig(PortConfig):
    """The port's Config on host crypto planes (the JAX Config's default)."""

    signature_backend: str = "cpu"
    hash_backend: str = "cpu"


# test_txq's module names, and the port's object for each
PORT_NAMES = {
    "lm_mod": port_lm_mod, "Config": CpuConfig, "LocalTxs": LocalTxs,
    "NORMAL_FEE": NORMAL_FEE, "LoadFeeTrack": LoadFeeTrack, "Node": Node,
    "NORMAL_LEVEL": NORMAL_LEVEL, "FeeMetrics": FeeMetrics, "fee_level": fee_level,
    "TxType": TxType, "KeyPair": KeyPair, "sfAmount": port_sfields.sfAmount,
    "sfBalance": port_sfields.sfBalance, "sfDestination": port_sfields.sfDestination,
    "STAmount": STAmount, "SerializedTransaction": SerializedTransaction, "TER": TER,
    "Context": Context, "Role": Role, "dispatch": dispatch,
}
# names a test body imports from the JAX package inside itself
PORT_INLINE = [(jax_sfields, "sfFee", port_sfields.sfFee),
               (jax_sfields, "sfSequence", port_sfields.sfSequence),
               (jax_netops, "TxStatus", TxStatus)]


def recording(make_node, log: list):
    """test_txq.make_node, with every node it makes logging its submits
    and closes."""
    def make(**kw):
        node = make_node(**kw)
        tag = len({entry[0] for entry in log})
        submit, accept = node.submit, node.ops.accept_ledger

        def logged_submit(tx):
            ter, applied = submit(tx)
            log.append((tag, "submit", tx.txid().hex(), ter.token, bool(applied)))
            return ter, applied

        def logged_accept():
            closed, results = accept()
            log.append((tag, "close", closed.seq, closed.hash().hex(),
                        sorted((t.hex(), r.token) for t, r in results.items())))
            return closed, results

        node.submit, node.ops.accept_ledger = logged_submit, logged_accept
        return node

    return make


def run_method(module, cls, name: str, tmp_path=None, kwargs=None) -> None:
    """One test method of a test module's class, called with `kwargs`
    (a parametrized case's arguments) and the fixtures it asks for
    resolved by name as pytest would (the class's or the module's
    fixture functions, ``monkeypatch``, ``tmp_path``), each made fresh
    for this run and torn down after it."""
    inst = cls()
    made, gens = {}, []

    def resolve(param, mp):
        if param not in made:
            if param == "monkeypatch":
                made[param] = mp
            elif param == "tmp_path":
                made[param] = tmp_path
            else:
                fix = cls.__dict__.get(param) or vars(module)[param]
                fn = fix.__wrapped__
                args = [resolve(q, mp) for q in inspect.signature(fn).parameters
                        if q != "self"]
                if "self" in inspect.signature(fn).parameters:
                    args.insert(0, inst)
                value = fn(*args)
                if inspect.isgenerator(value):
                    gens.append(value)
                    value = next(value)
                made[param] = value
        return made[param]

    fn = getattr(inst, name)
    with pytest.MonkeyPatch.context() as mp:
        call = dict(kwargs or {})
        for q in inspect.signature(fn).parameters:
            if q not in call:
                call[q] = resolve(q, mp)
        try:
            fn(**call)
        finally:
            for gen in reversed(gens):
                next(gen, None)


def cases(module=tq):
    """A pytest param for every test method of every Test class of
    ``module``."""
    out = []
    for cname, cls in vars(module).items():
        if cname.startswith("Test") and inspect.isclass(cls):
            for mname in dir(cls):
                if mname.startswith("test_"):
                    out.append(pytest.param(cls, mname, id=f"{cname}.{mname}"))
    return out


@pytest.mark.parametrize(("cls", "name"), cases())
def test_txq_case_equal_to_jax(monkeypatch, cls, name):
    logs = {"jax": [], "port": []}
    make_node = tq.make_node
    monkeypatch.setattr(tq, "make_node", recording(make_node, logs["jax"]))
    run_method(tq, cls, name)
    with pytest.MonkeyPatch.context() as mp:
        for attr, obj in PORT_NAMES.items():
            mp.setattr(tq, attr, obj)
        for mod, attr, obj in PORT_INLINE:
            mp.setattr(mod, attr, obj)
        mp.setattr(tq, "make_node", recording(make_node, logs["port"]))
        run_method(tq, cls, name)
    assert logs["port"] == logs["jax"]


def test_every_txq_case_runs_here():
    """Every class of test_txq.py is covered (none is left out)."""
    classes = {c.values[0].__name__ for c in cases()}
    assert classes == {n for n, c in vars(tq).items()
                       if n.startswith("Test") and inspect.isclass(c)}
    assert len(cases()) >= 30


def test_port_names_are_the_port():
    """The names put in test_txq's place are the port's, and its node
    runs the port's TxQ on host crypto planes."""
    with pytest.MonkeyPatch.context() as mp:
        for attr, obj in PORT_NAMES.items():
            mp.setattr(tq, attr, obj)
        node = tq.make_node(txq_min_cap=4, txq_max_cap=4)
        try:
            assert type(node).__module__ == "stellard_tpu_torch.node.node"
            assert type(node.txq).__module__ == "stellard_tpu_torch.node.txq"
            assert node.config.signature_backend == "cpu"
            assert node.ledger_master.txq is node.txq
        finally:
            node.stop()
