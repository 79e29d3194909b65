"""The port's overlay defense on real sockets, its SNTP clock, its
validator list sources, its node identity and its TLS doors against the
JAX package's.

Each test below runs twice, as it is and on its port twin, through
test_torch_tcp's twin runner (records equal, zero tolerance):

- tests/test_overlay_defense.py's TCP classes: ``TestSendqDiscipline``
  (a peer session's send queue), ``TestTcpHostileFlood`` (a handshaked
  hostile client against a live overlay, ``testkit.tcpnet.
  hostile_flood``) and ``TestCondemnCharge``;
- tests/test_aux_subsystems.py's ``TestSntp`` (``node/netclock.py``)
  and ``TestOverlayHardening`` (the protocol-version gate, a slow
  reader, and the cluster's load fee over ``TcpOverlay``);
- tests/test_ops_plane.py's ``TestValidatorSources``
  (``node/sitefiles.py`` and the networked ``Node``'s list sources) and
  ``TestLocalCredentials`` (the node identity);
- tests/test_rpc_server.py's ``TestSecureDoors`` (the ``[rpc_secure]``
  and ``[websocket_secure]`` doors through ``make_door_ssl_context``),
  whose record also holds every answer the test reads over TLS, with
  test_torch_rpc's volatile and random fields scrubbed.
"""

from __future__ import annotations

import json
import types

import pytest

import test_aux_subsystems as tas
import test_ops_plane as tops
import test_overlay_defense as tod
import test_rpc_server as trs
from test_torch_consensus import cases
from test_torch_node import scrub
from test_torch_rpc import RANDOM
from test_torch_tcp import net_deadline, tcp_recorder, tcp_twin_runs  # noqa: F401

DEFENSE = ("TestSendqDiscipline", "TestTcpHostileFlood", "TestCondemnCharge")
AUX = ("TestSntp", "TestOverlayHardening")
OPS = ("TestValidatorSources", "TestLocalCredentials")


def only(module, classes) -> list:
    """The twin-run cases of ``classes`` in ``module``."""
    skip = [n for n in vars(module) if n.startswith("Test") and n not in classes]
    return cases(module, skip=skip)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), only(tod, DEFENSE))
def test_overlay_defense_tcp_case_equal_to_jax(cname, mname, kwargs, tcp_recorder,  # noqa: F811
                                               tmp_path):
    tcp_twin_runs("test_overlay_defense", cname, mname, kwargs, tcp_recorder, tmp_path)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), only(tas, AUX))
def test_aux_subsystems_case_equal_to_jax(cname, mname, kwargs, tcp_recorder,  # noqa: F811
                                          tmp_path):
    tcp_twin_runs("test_aux_subsystems", cname, mname, kwargs, tcp_recorder, tmp_path)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), only(tops, OPS))
def test_ops_plane_case_equal_to_jax(cname, mname, kwargs, tcp_recorder,  # noqa: F811
                                     tmp_path):
    tcp_twin_runs("test_ops_plane", cname, mname, kwargs, tcp_recorder, tmp_path)


def answer_log(log: list) -> types.SimpleNamespace:
    """A ``json`` module for a test module whose every parsed answer is
    appended to ``log``, scrubbed of volatile and random fields."""
    def load(fp, **kw):
        out = json.load(fp, **kw)
        log.append(scrub(out, RANDOM))
        return out

    def loads(s, **kw):
        out = json.loads(s, **kw)
        log.append(scrub(out, RANDOM))
        return out

    return types.SimpleNamespace(load=load, loads=loads, dumps=json.dumps)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), only(trs, ("TestSecureDoors",)))
def test_secure_door_case_equal_to_jax(cname, mname, kwargs, tcp_recorder,  # noqa: F811
                                       tmp_path, monkeypatch):
    answers = {"jax": [], "port": []}
    from test_torch_tcp import tcp_twin

    monkeypatch.setattr(trs, "json", answer_log(answers["jax"]))
    monkeypatch.setattr(tcp_twin("test_rpc_server"), "json", answer_log(answers["port"]))
    tcp_twin_runs("test_rpc_server", cname, mname, kwargs, tcp_recorder, tmp_path)
    assert answers["port"] == answers["jax"]


def test_twin_runs_cover_the_classes():
    assert len(only(tod, DEFENSE)) == 7 and len(only(tas, AUX)) == 6
    assert len(only(tops, OPS)) == 5 and len(only(trs, ("TestSecureDoors",))) == 3
