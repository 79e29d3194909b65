"""The port's archive tier (node/archive.py, the archive ``Node``) against
the JAX package's.

Every test of tests/test_archive.py runs
twice here, in one test: once as it is (the JAX package) and once on its
port twin (its source with ``stellard_tpu.`` read as
``stellard_tpu_torch.``, the port's Config on host crypto planes, as the
JAX Config's default). Both runs must pass, and what they leave must be
equal, with zero tolerance: every shard store's counters and shards,
every shard backfill's counters and state, every result cache's
counters (the forever tier's among them), and every shard file the run
wrote, byte for byte.

Then the archive ``Node`` of each package: a port archive refuses what
the JAX archive refuses, and builds the same planes (a never-trimming
txdb, a shard store, the forever tier fed from its floor).
"""

from __future__ import annotations

import pytest

import stellard_tpu.node.archive as jax_archive
import stellard_tpu.nodestore.shards as jax_shards
import stellard_tpu.rpc.readplane as jax_readplane
import stellard_tpu_torch.node.archive as port_archive
import stellard_tpu_torch.nodestore.shards as port_shards
import stellard_tpu_torch.rpc.readplane as port_readplane
import test_archive as jt
from test_torch_consensus import cases, port_twin
from test_torch_txq import CpuConfig, run_method

WATCHED = {
    "jax": ((jax_shards.HistoryShardStore, "shards"), (jax_archive.ShardBackfill, "backfills"),
            (jax_readplane.ResultCache, "caches")),
    "port": ((port_shards.HistoryShardStore, "shards"),
             (port_archive.ShardBackfill, "backfills"), (port_readplane.ResultCache, "caches")),
}
TWIN = {"jax": jt, "port": port_twin("test_archive")}
# a case whose concurrent trim thread decides which pages read the shard
# store: its read counters follow the thread's timing, run to run, in
# either package (the case's own assertion holds the pages' rows)
RACY = {"TestBoundaryPagingUnderTrim.test_threaded_trim_race":
        ("account_tx_queries", "account_tx_rows", "tx_faults")}


def recorded_run(pkg: str, cname: str, mname: str, kwargs: dict, tmp_path) -> dict:
    made = {"shards": [], "backfills": [], "caches": []}
    mod = TWIN[pkg]
    with pytest.MonkeyPatch.context() as mp:
        for cls, key in WATCHED[pkg]:
            def init(obj, *a, _init=cls.__init__, _key=key, **kw):
                _init(obj, *a, **kw)
                made[_key].append(obj)

            mp.setattr(cls, "__init__", init)
        if pkg == "port":
            mp.setattr(mod, "Config", CpuConfig)
        run_method(mod, getattr(mod, cname), mname, tmp_path=tmp_path, kwargs=kwargs)
    racy = RACY.get(f"{cname}.{mname}", ())
    return {
        "shards": [({k: v for k, v in s.get_json().items() if k not in racy}, s.shards())
                   for s in made["shards"]],
        "backfills": [b.get_json() for b in made["backfills"]],
        "caches": [c.get_json() for c in made["caches"]],
    }


def shard_files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.shard"))}


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(jt))
def test_archive_case_equal_to_jax(cname, mname, kwargs, tmp_path):
    logs, files = {}, {}
    for pkg in ("jax", "port"):
        path = tmp_path / pkg
        path.mkdir()
        logs[pkg] = recorded_run(pkg, cname, mname, kwargs, path)
        files[pkg] = shard_files(path)
    assert logs["port"] == logs["jax"]
    assert files["port"] == files["jax"]
    if cname == "TestShardBackfill" and mname != "test_nothing_to_do_completes":
        assert files["jax"]


def test_twin_runs_cover_the_file():
    covered = {p.values[0] for p in cases(jt)}
    assert covered == {n for n in vars(jt) if n.startswith("Test")}
    assert len(cases(jt)) >= 34


# -- the archive node ------------------------------------------------------------


def test_archive_node_planes_equal_to_jax(tmp_path):
    """A networked archive of each package (no peers): its txdb never
    trims, it holds a shard store at ``[archive] path=``, its node runs
    the follower plane (no proposing, no rounds) with a shard backfill,
    and its read plane publishes the store's floor; get_counts' archive
    block has the same keys."""
    import stellard_tpu.node.config as jax_config
    import stellard_tpu.node.node as jax_node
    import stellard_tpu.rpc.handlers as jax_handlers
    import stellard_tpu_torch.node.node as port_node
    import stellard_tpu_torch.rpc.handlers as port_handlers
    from test_torch_tcp_mixed import free_ports

    out = {}
    for pkg, cfg_cls, node_mod, handlers in (
            ("jax", jax_config.Config, jax_node, jax_handlers),
            ("port", CpuConfig, port_node, port_handlers)):
        root = tmp_path / pkg
        root.mkdir()
        node = node_mod.Node(cfg_cls(
            standalone=False, node_mode="archive", peer_port=free_ports(1)[0],
            database_path=str(root / "tx.db"), archive_path=str(root / "arch"),
            kernel_tuning="none")).setup()
        try:
            with pytest.raises(RuntimeError, match="never trims"):
                node.txdb.trim_below(3)
            vn = node.overlay.node
            counts = handlers.dispatch(handlers.Context(
                node=node, params={}, role=handlers.Role.ADMIN), "get_counts")
            out[pkg] = {
                "txdb": type(node.txdb).__name__,
                "shard_root": str(node.shardstore.root).endswith("arch"),
                "follower": (node.follower, node.archive, vn.follower, vn.proposing,
                             vn.validator_state),
                "serve_validated_default": node.serve_validated_default,
                "backfill": sorted(vn.shard_backfill.get_json()),
                "floor": node.read_plane.archive_floor,
                "counts": sorted(counts["archive"]),
                "follower_counts": sorted(counts["follower"]),
            }
        finally:
            node.stop()
    assert out["port"] == out["jax"]
    assert out["port"]["follower"] == (True, True, True, False, "follower")
