"""The port's RPC doors and handlers against the JAX package's.

Every test of tests/test_rpc_server.py (the HTTP and WebSocket doors on
real sockets, the hack battery, the path_find subscription) and of
tests/test_rpc_surface.py (the handlers in process, account_tx
pagination, the proof-of-work tokens) runs twice here, in one test: once
as it is (the JAX package) and once with the port's names in its
module's place, each node's close times pinned to its closing ledger's
sequence. Each run's assertions must hold, and every answer the test
reads — each `rpc`/`call` result and each WebSocket message — is
recorded: the two records must be equal, but for the fields
test_torch_node.VOLATILE names (the build string, the node identity,
clocks, the random bytes, the admission queue's measured sizes).

Left out of the twin runs, each for a reason and replaced below where
the port answers differently by design:

- the TLS doors (TestSecureDoors): their twin runs, which read their
  answers over TLS, are in test_torch_tcp_defense.py;
- the ledger cleaner (`test_ledger_cleaner_runs_clean`): its twin run,
  which holds the cleaner's answers but its wall-clock status polls, is
  in test_torch_cleaner.py;
- the profiler (`test_profile_captures_device_trace`,
  `test_trace_lifecycle_captures_xplane`): the port's `profile` records
  the card with torch.profiler, and without a CUDA device its start
  answers `internal`.
"""

from __future__ import annotations

import inspect

import pytest

import stellard_tpu.node.config as jax_config
import stellard_tpu.node.node as jax_node
import stellard_tpu.protocol.sfields as jax_sfields
import stellard_tpu.protocol.ter as jax_ter
import stellard_tpu.rpc.handlers as jax_handlers
import test_rpc_server as trs
import test_rpc_surface as tsu
from stellard_tpu_torch.node.node import Node as PortNode
from stellard_tpu_torch.protocol import sfields as port_sfields
from stellard_tpu_torch.protocol.formats import TxType
from stellard_tpu_torch.protocol.keys import KeyPair
from stellard_tpu_torch.protocol.stamount import STAmount, currency_from_iso
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.protocol.ter import TER
from stellard_tpu_torch.rpc.handlers import Context, Role, dispatch
from stellard_tpu_torch.utils.pow import PowFactory, ProofOfWork
from test_torch_node import VOLATILE, scrub
from test_torch_txq import CpuConfig, run_method

LEFT_OUT = {
    "TestSecureDoors": "run in test_torch_tcp_defense.py",
    "test_ledger_cleaner_runs_clean": "run in test_torch_cleaner.py",
    "test_profile_captures_device_trace": "the port's profile is torch.profiler on the card",
    "test_trace_lifecycle_captures_xplane": "the port's profile is torch.profiler on the card",
}


def pinned(node_cls):
    """``node_cls`` with its close times pinned to the closing ledger's
    sequence (the doors' tests close on the wall clock)."""
    class Pinned(node_cls):
        def __init__(self, config=None):
            super().__init__(config)
            self.ops.network_time = (
                lambda: 900_000_000 + self.ledger_master.current_ledger().seq * 30)

    return Pinned


def port_names(module) -> dict:
    names = {"Config": CpuConfig, "Node": pinned(PortNode), "KeyPair": KeyPair}
    if module is tsu:
        names.update(
            TxType=TxType, STAmount=STAmount, currency_from_iso=currency_from_iso,
            SerializedTransaction=SerializedTransaction, Context=Context, Role=Role,
            dispatch=dispatch, PowFactory=PowFactory, ProofOfWork=ProofOfWork,
            ALICE=KeyPair.from_passphrase("alice"), BOB=KeyPair.from_passphrase("bob"),
            **{n: getattr(port_sfields, n) for n in vars(tsu) if n.startswith("sf")})
    return names


# names a test body imports from the JAX package inside itself (the
# url subscription's test builds its own node and dispatches to it)
PORT_INLINE = [(jax_sfields, "sfLimitAmount", port_sfields.sfLimitAmount),
               (jax_ter, "TER", TER), (jax_config, "Config", CpuConfig),
               (jax_node, "Node", PortNode), (jax_handlers, "Context", Context),
               (jax_handlers, "Role", Role), (jax_handlers, "dispatch", dispatch)]


# besides test_torch_node.VOLATILE: what a node draws at random for an
# answer (a proof-of-work challenge, its token and solution, a validation
# key made without a secret); each run's own assertions hold these
RANDOM = VOLATILE | {"token", "challenge", "solution", "validation_public_key",
                       "validation_seed"}
# introspection dumps of the node's own planes and timers (the JAX
# node's XLA/TPU fields beside the port's CUDA ones, job and batch
# latencies): logged by name, their contents not compared
INTROSPECTION = frozenset({"print", "get_counts", "server_state"})


def recording(module, log: list) -> dict:
    """The module's answer readers, each logging what it read."""
    out = {}
    reader = "rpc" if module is trs else "call"
    orig = getattr(module, reader)

    def read(*a, **kw):
        r = orig(*a, **kw)
        method = a[1] if len(a) > 1 else kw.get("method")
        log.append((reader, method, None if method in INTROSPECTION else scrub(r, RANDOM)))
        return r

    out[reader] = read
    if module is trs:
        class Ws(module.WsClient):
            def recv(self):
                msg = super().recv()
                log.append(("ws", scrub(msg, RANDOM)))
                return msg

        out["WsClient"] = Ws
    return out


def cases(module):
    out = []
    for cname, cls in vars(module).items():
        if not (cname.startswith("Test") and inspect.isclass(cls)) or cname in LEFT_OUT:
            continue
        for mname in dir(cls):
            if mname.startswith("test_") and mname not in LEFT_OUT:
                out.append(pytest.param(module, cls, mname, id=f"{cname}.{mname}"))
    return out


@pytest.mark.parametrize(("module", "cls", "name"), cases(trs) + cases(tsu))
def test_rpc_case_equal_to_jax(tmp_path, module, cls, name):
    logs = {"jax": [], "port": []}
    for side in ("jax", "port"):
        path = tmp_path / side
        path.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            if side == "jax":
                mp.setattr(module, "Node", pinned(module.Node))
            else:
                for attr, obj in port_names(module).items():
                    mp.setattr(module, attr, obj)
                for mod, attr, obj in PORT_INLINE:
                    mp.setattr(mod, attr, obj)
            for attr, obj in recording(module, logs[side]).items():
                mp.setattr(module, attr, obj)
            run_method(module, cls, name, tmp_path=path)
    assert logs["port"] == logs["jax"]


def test_twin_runs_cover_both_files():
    assert len(cases(trs)) >= 14 and len(cases(tsu)) >= 30


# -- what the port answers by design -----------------------------------------


@pytest.fixture()
def port_node(tmp_path):
    node = PortNode(CpuConfig(rpc_port=0, websocket_port=0,
                              database_path=str(tmp_path / "tx.db"))).setup().serve()
    yield node
    node.stop()


def port_call(node, method, **params):
    return dispatch(Context(node=node, params=params, role=Role.ADMIN), method)


def test_ledger_cleaner_answers_not_implemented(port_node):
    """The cleaner is part of the port now: every verb answers as the
    JAX node's does (the status of an idle cleaner, a scan of one
    ledger, a stop) and none answers notImpl."""
    idle = port_call(port_node, "ledger_cleaner")
    assert idle["state"] == "idle" and idle["checked"] == 0
    assert port_call(port_node, "ledger_cleaner", ledger=1) == {
        "status": "started", "min_ledger": 1, "max_ledger": 1}
    stopped = port_call(port_node, "ledger_cleaner", stop=True)
    assert stopped["state"] in ("running", "done", "stopped")
    assert stopped["failure_count"] == 0
    for params in ({}, {"ledger": 1}, {"stop": True}):
        assert "error" not in port_call(port_node, "ledger_cleaner", **params)


def test_profile_without_a_card(port_node, tmp_path):
    """Without a CUDA device the torch profiler has nothing to record:
    start answers internal and leaves no trace running; stop and status
    answer as with no trace."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the profiler records it")
    r = port_call(port_node, "profile", action="start", dir=str(tmp_path / "trace"))
    assert r["error"] == "internal" and "profiler start failed" in r["error_message"]
    assert port_call(port_node, "profile", action="status")["status"] == "idle"
    assert port_call(port_node, "profile", action="stop")["error"] == "internal"


def test_url_subscription_answers_not_implemented(port_node):
    """A url subscription is part of the port now: it answers as the JAX
    node's does (success, an RpcSub registered for the url), and never
    notImpl."""
    r = trs.rpc(port_node, "subscribe", url="http://127.0.0.1:1/", streams=["ledger"])
    assert r["status"] == "success" and "error" not in r
    assert type(port_node.subs.rpc_subs["http://127.0.0.1:1/"]).__module__ == (
        "stellard_tpu_torch.rpc.rpcsub")
