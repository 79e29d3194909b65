"""The port's follower plane and read plane against the JAX package's.

Every test of tests/test_follower_tree.py (the follower tree's plan,
the simulated net's upstreams, the fanout's resume cursors, the
follower's kick coalescing, the epoch-pinned segment handoff) and of
tests/test_read_plane.py (the validated snapshot, the result cache, the
sharded fanout, ``RpcSub``'s retry, the account_tx retention floor, the
follower flag and the follower's serve-validated default) runs twice
here, in one test: once as it is (the JAX package) and once on its port
twin (its source with ``stellard_tpu.`` read as ``stellard_tpu_torch.``,
the port's Config on host crypto planes, as the JAX Config's default).
Both runs must pass, and what they leave must be equal, with zero
tolerance: every read plane's and result cache's counters, every
follower's ingest counters (its latency quantiles aside), every segment
catch-up's counters, and every ``RpcSub``'s events and deliveries.

The fanout's delivery counters and an ``RpcSub``'s failure counts follow
its threads' timing, run to run, in either package; each case's own
assertions hold them.
"""

from __future__ import annotations

import pytest

import stellard_tpu.node.inbound as jax_inbound
import stellard_tpu.node.validator as jax_validator
import stellard_tpu.rpc.readplane as jax_readplane
import stellard_tpu.rpc.rpcsub as jax_rpcsub
import stellard_tpu_torch.node.inbound as port_inbound
import stellard_tpu_torch.node.validator as port_validator
import stellard_tpu_torch.rpc.readplane as port_readplane
import stellard_tpu_torch.rpc.rpcsub as port_rpcsub
import test_follower_tree as jft
import test_read_plane as jrp
from test_torch_consensus import cases, port_twin
from test_torch_txq import CpuConfig, run_method

MODULES = {"test_follower_tree": jft, "test_read_plane": jrp}
WATCHED = {
    "jax": ((jax_readplane.ReadPlane, "planes"), (jax_readplane.ResultCache, "caches"),
            (jax_validator.ValidatorNode, "followers"), (jax_inbound.SegmentCatchup, "catchups"),
            (jax_rpcsub.RpcSub, "pushers")),
    "port": ((port_readplane.ReadPlane, "planes"), (port_readplane.ResultCache, "caches"),
             (port_validator.ValidatorNode, "followers"),
             (port_inbound.SegmentCatchup, "catchups"), (port_rpcsub.RpcSub, "pushers")),
}


def follower_state(vn) -> dict:
    out = vn.follower_json()
    out.pop("ingest_p50_ms", None)
    out.pop("ingest_p99_ms", None)
    return {"follower": vn.follower, "state": vn.validator_state,
            "proposing": vn.proposing, **out}


def recorded_run(pkg: str, name: str, cname: str, mname: str, kwargs: dict, tmp_path) -> dict:
    made = {key: [] for _cls, key in WATCHED[pkg]}
    mod = MODULES[name] if pkg == "jax" else port_twin(name)
    with pytest.MonkeyPatch.context() as mp:
        for cls, key in WATCHED[pkg]:
            def init(obj, *a, _init=cls.__init__, _key=key, **kw):
                _init(obj, *a, **kw)
                made[_key].append(obj)

            mp.setattr(cls, "__init__", init)
        if pkg == "port":
            mp.setattr(mod, "Config", CpuConfig)
        run_method(mod, getattr(mod, cname), mname, tmp_path=tmp_path, kwargs=kwargs)
    return {
        "planes": [p.get_json() for p in made["planes"]],
        "caches": [c.get_json() for c in made["caches"]],
        "followers": [follower_state(v) for v in made["followers"] if v.follower],
        "catchups": [c.get_json() for c in made["catchups"]],
        # events queued (each stamped with the next seq) and delivered
        "pushers": [(p._seq - 1, p.stats["sent"]) for p in made["pushers"]],
    }


def twin(name: str, cname: str, mname: str, kwargs: dict, tmp_path) -> None:
    logs = {}
    for pkg in ("jax", "port"):
        path = tmp_path / pkg
        path.mkdir()
        logs[pkg] = recorded_run(pkg, name, cname, mname, kwargs, path)
    assert logs["port"] == logs["jax"]


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(jft))
def test_follower_tree_case_equal_to_jax(cname, mname, kwargs, tmp_path):
    twin("test_follower_tree", cname, mname, kwargs, tmp_path)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(jrp))
def test_read_plane_case_equal_to_jax(cname, mname, kwargs, tmp_path):
    twin("test_read_plane", cname, mname, kwargs, tmp_path)


def test_twin_runs_cover_both_files():
    assert len(cases(jft)) >= 17 and len(cases(jrp)) >= 26
    for mod in (jft, jrp):
        assert {p.values[0] for p in cases(mod)} == {n for n in vars(mod)
                                                     if n.startswith("Test")}
