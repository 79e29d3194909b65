"""The port's health watchdog and flight recorder (node/health.py) against
the JAX package's.

Every test of tests/test_health.py runs twice here, in one test: once as
it is (the JAX package) and once on its port twin (its source with
``stellard_tpu.`` read as ``stellard_tpu_torch.``). Both runs must pass,
and what they leave must be equal, with zero tolerance: every watchdog's
verdict (status, reasons, transitions, evaluations, EWMA, seqs), every
recorder's occupancy and the dumps it wrote (their names, relative to
the run's directory, and their JSON but the wall clock of the dump and
of each span).

Then the node: a port ``Node`` and a JAX ``Node`` built from the same
default Config both run the watchdog (on by default in both packages)
and the flight recorder, and both answer ``health`` and ``get_counts``
with the same blocks.
"""

from __future__ import annotations

import json
import os

import pytest

import stellard_tpu.node.health as jax_health
import stellard_tpu_torch.node.health as port_health
import test_health as jt
from test_torch_consensus import cases, port_twin
from test_torch_txq import CpuConfig, run_method

HEALTH = {"jax": jax_health, "port": port_health}
TWIN = {"jax": jt, "port": port_twin("test_health")}


def dump_content(path: str) -> dict:
    """A dump's JSON without its clocks (the dump's wall time, and each
    span's)."""
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    payload.pop("wall_time")
    payload["spans"] = [span[1:] for span in payload["spans"]]
    return payload


def recorded_run(pkg: str, cname: str, mname: str, kwargs: dict, tmp_path) -> dict:
    health = HEALTH[pkg]
    made = {"watchdogs": [], "recorders": []}
    with pytest.MonkeyPatch.context() as mp:
        for cls, key in ((health.HealthWatchdog, "watchdogs"),
                         (health.FlightRecorder, "recorders")):
            def init(obj, *a, _init=cls.__init__, _key=key, **kw):
                _init(obj, *a, **kw)
                made[_key].append(obj)

            mp.setattr(cls, "__init__", init)
        mod = TWIN[pkg]
        run_method(mod, getattr(mod, cname), mname, tmp_path=tmp_path, kwargs=kwargs)
    recorders = []
    for rec in made["recorders"]:
        j = rec.get_json()
        dumps = j.pop("dumps")
        recorders.append({
            **j,
            "dumps": [(os.path.relpath(p, tmp_path), dump_content(p)) for p in dumps],
        })
    return {"watchdogs": [wd.get_json() for wd in made["watchdogs"]],
            "recorders": recorders}


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(jt))
def test_health_case_equal_to_jax(cname, mname, kwargs, tmp_path):
    logs = {}
    for pkg in ("jax", "port"):
        path = tmp_path / pkg
        path.mkdir()
        logs[pkg] = recorded_run(pkg, cname, mname, kwargs, path)
    assert logs["port"] == logs["jax"]


def test_twin_runs_cover_the_file():
    assert len(cases(jt)) >= 19


def test_the_twin_runs_the_port():
    assert TWIN["port"].HealthWatchdog is port_health.HealthWatchdog
    assert TWIN["port"].FlightRecorder is port_health.FlightRecorder


# -- the node ----------------------------------------------------------------------


def test_default_node_runs_the_watchdog_as_the_jax_node(tmp_path):
    """The default Config of both packages turns the watchdog on; each
    node builds the recorder in ``<database_path>.flight``, feeds the
    watchdog its closes and validations, and answers ``health`` and
    ``get_counts``' blocks alike."""
    import stellard_tpu.node.config as jax_config
    import stellard_tpu.node.node as jax_node
    import stellard_tpu.rpc.handlers as jax_handlers
    import stellard_tpu_torch.node.node as port_node
    import stellard_tpu_torch.rpc.handlers as port_handlers

    assert CpuConfig().health_enabled
    assert jax_config.Config().health_enabled
    out = {}
    for pkg, cfg_cls, node_mod, handlers in (
            ("jax", jax_config.Config, jax_node, jax_handlers),
            ("port", CpuConfig, port_node, port_handlers)):
        db = tmp_path / pkg / "tx.db"
        db.parent.mkdir()
        node = node_mod.Node(cfg_cls(database_path=str(db), kernel_tuning="none")).setup()
        try:
            node.ops.network_time = (
                lambda n=node: 900_000_000 + n.ledger_master.current_ledger().seq * 30)
            for _ in range(3):
                node.close_ledger()
            node.health.evaluate(now=node.health._last_close_ts)

            def call(method, h=handlers, n=node):
                return h.dispatch(h.Context(node=n, params={}, role=h.Role.ADMIN), method)

            answer = call("health")
            counts = call("get_counts")
            out[pkg] = {
                "flight_dir": os.path.relpath(node.flight.directory, tmp_path / pkg),
                "tracer_feeds_flight": node.tracer.flight is node.flight,
                "health": {k: v for k, v in answer["health"].items()
                           if k != "ewma_close_gap_s"},
                "enabled": answer["enabled"],
                "flight": answer["flight"]["dumps"],
                "counts_health": sorted(counts["health"]),
                "counts_flight": sorted(counts["flight"]),
            }
        finally:
            node.stop()
    assert out["port"] == out["jax"]
    assert out["port"]["health"]["closed_seq"] == 4
    assert out["port"]["flight_dir"] == "tx.db.flight"
