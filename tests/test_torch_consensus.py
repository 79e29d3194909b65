"""The port's consensus plane (consensus/, the wire codec overlay/proto.py
and overlay/wire.py) against the JAX package's.

- **Port runs of the JAX tests.** Every test of tests/test_consensus.py,
  tests/test_voting.py and tests/test_wire_proto.py runs twice: once as
  it is, and once as a twin of its module in which every name of the JAX
  package is the port's (the module's source with ``stellard_tpu.`` read
  as ``stellard_tpu_torch.``, so the names a test body imports inside
  itself are the port's too). Each run's assertions must hold, and each
  records, for every SimNet, ValidatorNode, AmendmentTable and FeeVote
  the test made, what it ended with: validated and closed seqs and
  hashes, the ledger index, consensus_info, the defense counters, the
  net's counters, its accept log and the vote outcomes. The two records
  must be equal (tolerance zero: these are bytes and counts).
- **Frames across the packages.** Every message of the wire schema,
  framed by one package, is read back by the other's FrameReader as the
  same fields, and both packages frame it to the same bytes.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import inspect
import sys
import types
from pathlib import Path

import pytest

import stellard_tpu.consensus.validations as jax_validations
import stellard_tpu.consensus.voting as jax_voting
import stellard_tpu.node.validator as jax_validator
import stellard_tpu.overlay.simnet as jax_simnet
import stellard_tpu.overlay.wire as JW
import stellard_tpu_torch.consensus.validations as port_validations
import stellard_tpu_torch.consensus.voting as port_voting
import stellard_tpu_torch.node.validator as port_validator
import stellard_tpu_torch.overlay.simnet as port_simnet
import stellard_tpu_torch.overlay.wire as PW
from test_torch_txq import run_method

TESTS = Path(__file__).resolve().parent

# the classes whose instances a twin run records, per package
WATCHED = {
    "jax": (jax_simnet.SimNet, jax_validator.ValidatorNode,
            jax_voting.AmendmentTable, jax_voting.FeeVote),
    "port": (port_simnet.SimNet, port_validator.ValidatorNode,
             port_voting.AmendmentTable, port_voting.FeeVote),
}
# the calls whose answers a twin run records: the vote outcomes and the
# validation store's quorum answers
CALLS = (("AmendmentTable", ("do_validation", "do_voting")),
         ("FeeVote", ("do_validation", "do_voting")),
         ("VotingBox", ("validation_fields", "position_injections")),
         ("ValidationsStore", ("add", "can_sign", "trusted_count_for",
                               "current_ledger_weights")))
CALL_MODULES = {"jax": (jax_voting, jax_validations),
                "port": (port_voting, port_validations)}


def port_twin(name: str) -> types.ModuleType:
    """tests/<name>.py with every name of the JAX package the port's: its
    source compiled with ``stellard_tpu`` read as ``stellard_tpu_torch``
    (``__file__`` stays the JAX test's, for the paths it derives)."""
    twin_name = f"{name}__port"
    if twin_name in sys.modules:
        return sys.modules[twin_name]
    path = TESTS / f"{name}.py"
    src = path.read_text()
    src = src.replace("stellard_tpu.", "stellard_tpu_torch.").replace(
        "from stellard_tpu import", "from stellard_tpu_torch import")
    mod = types.ModuleType(twin_name)
    mod.__file__ = str(path)
    sys.modules[twin_name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _params(fn) -> list:
    """The kwargs of each call pytest would make of `fn` (its
    ``parametrize`` marks, outermost first), as (id, kwargs)."""
    calls = [("", {})]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        expanded = []
        for cid, kw in calls:
            for i, v in enumerate(values):
                vals = v if len(names) > 1 else (v,)
                expanded.append((f"{cid}{i}-", {**kw, **dict(zip(names, vals))}))
        calls = expanded
    return calls


def cases(module, skip=()) -> list:
    """A pytest param for every call of every test method of every Test
    class of `module`, but those named in `skip` (``Class.method`` or
    ``Class``)."""
    out = []
    for cname, cls in vars(module).items():
        if not (cname.startswith("Test") and inspect.isclass(cls)) or cname in skip:
            continue
        for mname in sorted(dir(cls)):
            if not mname.startswith("test_") or f"{cname}.{mname}" in skip:
                continue
            for cid, kw in _params(getattr(cls, mname)):
                out.append(pytest.param(cname, mname, kw,
                                        id=f"{cname}.{mname}[{cid[:-1]}]" if cid
                                        else f"{cname}.{mname}"))
    return out


def _history(lm) -> list:
    return sorted((seq, h.hex()) for seq, h in lm.ledger_history.items())


def plain_value(v):
    """An answer in plain values, comparable across the packages."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).hex()
    if isinstance(v, enum.Enum):  # a TER, a TxType: its value
        return v.value
    if isinstance(v, (bool, int, str, float)) or v is None:
        return v
    if hasattr(v, "serialize"):
        return v.serialize().hex()
    if isinstance(v, dict):
        return sorted((plain_value(k), plain_value(x)) for k, x in v.items())
    if isinstance(v, (list, tuple, set, frozenset)):
        out = [plain_value(x) for x in v]
        return sorted(out) if isinstance(v, (set, frozenset)) else out
    return type(v).__name__


def state_of(obj) -> dict:
    """What a recorded object ended with, in plain values."""
    name = type(obj).__name__
    if hasattr(obj, "net_stats"):  # a SimNet
        return {"net_stats": dict(obj.net_stats), "time_ms": obj.time_ms,
                "accept_log": [(n, s, h.hex()) for n, s, h in obj.accept_log],
                "validated": obj.validated_seqs()}
    if hasattr(obj, "defense"):  # a ValidatorNode
        lm = obj.lm
        out = {"defense": obj.defense.snapshot(), "history": _history(lm),
               "rounds": obj.rounds_completed}
        if lm.closed is not None:
            out["info"] = obj.consensus_info()
            out["closed"] = (lm.closed.seq, lm.closed.hash().hex())
        if lm.validated is not None:
            out["validated"] = (lm.validated.seq, lm.validated.hash().hex())
        return out
    if hasattr(obj, "get_json"):  # an AmendmentTable
        return {name: obj.get_json()}
    return {name: {k: v for k, v in vars(obj).items() if isinstance(v, (int, str))}}


@pytest.fixture
def recorder():
    """Records every watched object made while a twin run lasts; ``take``
    returns their end states, in the order they were made."""
    made: list = []
    calls: list = []

    class Recorder:
        def __init__(self):
            self.mp = pytest.MonkeyPatch()

        def watch(self, pkg: str):
            for cls in WATCHED[pkg]:
                init = cls.__init__

                def wrapped(obj, *a, _init=init, **kw):
                    _init(obj, *a, **kw)
                    if not any(o is obj for o in made):
                        made.append(obj)

                self.mp.setattr(cls, "__init__", wrapped)
            for cname, methods in CALLS:
                cls = next(getattr(m, cname) for m in CALL_MODULES[pkg] if hasattr(m, cname))
                for meth in methods:
                    fn = getattr(cls, meth)

                    def logged(obj, *a, _fn=fn, _tag=(cname, meth), **kw):
                        out = _fn(obj, *a, **kw)
                        calls.append((*_tag, plain_value(out)))
                        return out

                    self.mp.setattr(cls, meth, logged)

        def take(self) -> list:
            self.mp.undo()
            out = [state_of(o) for o in made] + [("calls", list(calls))]
            made.clear()
            calls.clear()
            return out

    r = Recorder()
    yield r
    r.mp.undo()


def twin_runs(name: str, cname: str, mname: str, kwargs: dict, recorder, tmp_path) -> None:
    """The test run as it is and on its port twin; both must pass, and
    what the watched objects ended with must be equal."""
    jax_mod = importlib.import_module(name)
    logs = {}
    for pkg, mod in (("jax", jax_mod), ("port", port_twin(name))):
        recorder.watch(pkg)
        path = tmp_path / pkg
        path.mkdir()
        try:
            run_method(mod, getattr(mod, cname), mname, tmp_path=path, kwargs=kwargs)
        finally:
            logs[pkg] = recorder.take()
    assert logs["port"] == logs["jax"]


import test_consensus as tc  # noqa: E402
import test_voting as tv  # noqa: E402
import test_wire_proto as tw  # noqa: E402


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(tc))
def test_consensus_case_equal_to_jax(cname, mname, kwargs, recorder, tmp_path):
    twin_runs("test_consensus", cname, mname, kwargs, recorder, tmp_path)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(tv))
def test_voting_case_equal_to_jax(cname, mname, kwargs, recorder, tmp_path):
    twin_runs("test_voting", cname, mname, kwargs, recorder, tmp_path)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(tw))
def test_wire_proto_case_equal_to_jax(cname, mname, kwargs, recorder, tmp_path):
    twin_runs("test_wire_proto", cname, mname, kwargs, recorder, tmp_path)


# -- frames across the packages -----------------------------------------------

H32 = bytes(range(32))


def every_message(W) -> list:
    """One message of every type of the schema, with trace contexts and
    the segment doors' fields, built from package `W`'s wire module."""
    ctx = W.TraceContext(b"\x07" * 32, 0x0102030405, True)
    return [
        W.Hello(1, 99, b"\x02" * 32, b"\x03" * 64, 7, H32, 1234),
        W.Ping(False, 3), W.Ping(True, 4),
        W.TxMessage(b"tx-blob"), W.TxMessage(b"tx-blob-2", trace_ctx=ctx),
        W.ProposeSet(1, 2, b"\x01" * 32, b"\x02" * 32, b"\x03" * 32, b"\x04" * 64),
        W.ProposeSet(5, 6, H32, H32, H32, b"\x09" * 64, trace_ctx=ctx),
        W.ValidationMessage(b"val-blob"), W.ValidationMessage(b"v2", trace_ctx=ctx),
        W.HaveTxSet(H32), W.GetTxSet(H32),
        W.TxSetData(H32, [b"a", b"bb", b""]),
        W.GetLedger(H32, 0, 2, [b"\x00", b"\x01\x23"]),
        W.LedgerData(H32, 9, 1, [(b"\x00", b"blob"), (b"\x01\x02", b"")]),
        W.StatusChange(4, 12, H32, 555),
        W.Endpoints([("127.0.0.1", 1024, 0), ("192.168.0.9", 2, 7)]),
        W.ClusterUpdate([W.ClusterStatus(b"\x05" * 32, 512, 777),
                         W.ClusterStatus(b"\x06" * 32, 256, 778)]),
        W.GetSegments(-1), W.GetSegments(3, 1 << 20, 4096),
        W.SegmentData(-1, segments=[(1, 100, 90, True, 0, 0, 0), (2, 50, 50, False, 10, 20, 4096)],
                      snap_epoch=4, snap_seq=77),
        W.SegmentData(3, offset=4096, data=b"\xaa" * 300, total=1 << 20),
        W.GetObjects([H32, bytes(32)]), W.ObjectsData([(H32, b"payload")]),
    ]


def plain(msg):
    """A message's type name and fields, with nested dataclasses as
    dicts (comparable across the two packages)."""
    return (type(msg).__name__, dataclasses.asdict(msg))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frames_read_across_packages(writer):
    """Framed by one package, fed to the other's reader in awkward
    chunks: the same messages; and both packages frame them to the same
    bytes."""
    src, dst = (JW, PW) if writer == "jax" else (PW, JW)
    msgs = every_message(src)
    stream = b"".join(src.frame(m) for m in msgs)
    assert stream == b"".join(dst.frame(m) for m in every_message(dst))
    reader = dst.FrameReader()
    got = []
    for i in range(0, len(stream), 5):
        got.extend(reader.feed(stream[i : i + 5]))
    assert [plain(m) for m in got] == [plain(m) for m in msgs]
