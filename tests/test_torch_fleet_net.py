"""The fleet roles on one TCP net of both packages, on the CPU.

Two JAX and two port validator ``Node``s on localhost, every one on
every UNL, quorum 3 (no ledger validates without a validation from each
package), host crypto planes, clock speed 5:

- **Followers.** A port follower and a JAX follower (``[node]
  mode=follower``, no validation key) join with the validators and adopt
  every validated ledger: at every seq both hold, their hashes are the
  validators'. Both answer ``ledger``, ``account_info`` and
  ``account_tx`` at the same seqs equally, the volatile fields aside
  (test_torch_node.VOLATILE), and a selector-less read resolves their
  validated snapshot.
- **Archives.** JAX validator 0 and port validator 1 run ``[node_db]
  type=segstore online_delete=4 shards=1``, so both seal their retired
  history into shards. Once each has sealed, a port archive pinned to
  the JAX validator (``[node] upstream=``) and a JAX archive pinned to
  the port validator (``[node] mode=archive``) join and backfill every
  shard their upstream sealed, with no peer condemned. A shard of the
  same ledger range is the same file, byte for byte, in both archives,
  and the archives answer ``ledger`` by seq and ``account_tx`` over a
  sealed range below the validators' retained floor equally.

Every net test has its own deadline (test_torch_tcp.deadline).
"""

from __future__ import annotations

import os
import time

import stellard_tpu.node.config as jax_config
import stellard_tpu.node.node as jax_node
import stellard_tpu.rpc.handlers as jax_handlers
import stellard_tpu_torch.node.node as port_node
import stellard_tpu_torch.rpc.handlers as port_handlers
from stellard_tpu.protocol.keys import KeyPair
from test_torch_node import VOLATILE, scrub
from test_torch_tcp import deadline
from test_torch_tcp_mixed import free_ports, payment, protocol_of, wait_until
from test_torch_txq import CpuConfig

SPEED = 5.0
XRP = 1_000_000
PACKAGES = {
    "jax": (jax_config.Config, jax_node.Node, jax_handlers),
    "port": (CpuConfig, port_node.Node, port_handlers),
}
VALIDATORS = ("jax", "port", "jax", "port")
# the validators that seal their retired history, by index
SEALERS = (0, 1)


class FleetNet:
    """Validator Nodes of either package on one net, and the followers
    and archives that join it; every node is stopped with the net."""

    def __init__(self, tmp_path, tag: str, sealers=()):
        self.tmp = tmp_path
        self.keys = [KeyPair.from_passphrase(f"{tag}-val-{i}") for i in range(4)]
        self.ports = free_ports(4)
        self.nodes: list = []
        self.validators = []
        for i, pkg in enumerate(VALIDATORS):
            kw = dict(validation_seed=self.keys[i].human_seed,
                      ips=[f"127.0.0.1 {self.ports[j]}" for j in range(4) if j != i])
            if i in sealers:
                kw.update(node_db_type="segstore", node_db_path=str(tmp_path / f"v{i}-ns"),
                          node_db_segment_mb=1, node_db_online_delete=4,
                          node_db_online_delete_interval=2, node_db_shards="1")
            self.validators.append(self.start(pkg, f"v{i}", self.ports[i], **kw))

    def start(self, pkg: str, name: str, port: int, **kw):
        config_cls, node_cls, _h = PACKAGES[pkg]
        path = self.tmp / name
        path.mkdir()
        cfg = config_cls(
            standalone=False, signature_backend="cpu", hash_backend="cpu",
            validators=[k.human_node_public for k in self.keys], validation_quorum=3,
            peer_port=port, clock_speed=SPEED, database_path=str(path / "tx.db"),
            kernel_tuning="none", **kw)
        node = node_cls(cfg).setup().serve()
        node.pkg = pkg
        self.nodes.append(node)
        return node

    def join(self, pkg: str, name: str, mode: str, upstream=None, **kw):
        """A follower or an archive dialing every validator, or only the
        validator ``upstream`` (its index)."""
        dial = range(4) if upstream is None else (upstream,)
        addrs = [f"127.0.0.1 {self.ports[j]}" for j in dial]
        if upstream is None:
            kw["ips"] = addrs
        else:
            kw["node_upstream"] = addrs
        return self.start(pkg, name, free_ports(1)[0], node_mode=mode, **kw)

    def stop(self):
        for node in self.nodes:
            node.stop()


def validated(node) -> int:
    v = node.ledger_master.validated
    return v.seq if v is not None else 0


def history(node) -> dict:
    return dict(node.ledger_master.ledger_history)


def call(node, method: str, **params) -> dict:
    h = PACKAGES[node.pkg][2]
    return h.dispatch(h.Context(node=node, params=params, role=h.Role.ADMIN), method)


def submit_payments(node, dests, first_seq: int, drops: int) -> int:
    """One payment from the master account to each of ``dests``, built by
    the node's own package, submitted at ``node``; the next sequence."""
    p = protocol_of("stellard_tpu" if node.pkg == "jax" else "stellard_tpu_torch")
    for k, dest in enumerate(dests):
        ter, _applied = node.submit(payment(first_seq + k, dest, drops, p))
        assert int(ter) == 0, ter
    return first_seq + len(dests)


def test_followers_adopt_and_answer_as_the_validators(tmp_path):
    with deadline(240):
        net = FleetNet(tmp_path, "fleet-f")
        try:
            followers = [net.join("port", "fp", "follower"), net.join("jax", "fj", "follower")]
            assert wait_until(lambda: all(validated(n) >= 3 for n in net.nodes), 120), [
                validated(n) for n in net.nodes]
            dests = [KeyPair.from_passphrase(f"fleet-f-dest-{i}") for i in range(3)]

            def balance_on_all(drops):
                return lambda: all(
                    (n.ledger_master.validated or n.ledger_master.closed_ledger())
                    .account_root(dests[2].account_id) is not None
                    and call(n, "account_info", account=dests[2].human_account_id,
                             ledger_index="validated").get("account_data", {}).get(
                        "Balance") == str(drops) for n in net.nodes)

            # payments submitted at a port validator, then at a JAX one:
            # validated, and adopted by both followers
            seq = submit_payments(net.validators[1], dests, 1, 1000 * XRP)
            assert wait_until(balance_on_all(1000 * XRP), 120), [validated(n) for n in net.nodes]
            submit_payments(net.validators[0], dests, seq, 500 * XRP)
            assert wait_until(balance_on_all(1500 * XRP), 120), [validated(n) for n in net.nodes]
            for f in followers:
                vn = f.overlay.node
                assert vn.follower and vn.rounds_completed == 0 and vn.ledgers_ingested > 0
                assert f.serve_validated_default
            # every seq two nodes hold: one hash
            seqs = {}
            for n in net.nodes:
                for s, h in history(n).items():
                    if s <= validated(n):
                        seqs.setdefault(s, set()).add(h)
            assert all(len(h) == 1 for h in seqs.values()), seqs
            common = min(validated(f) for f in followers)
            both = [s for s in range(2, common + 1)
                    if all(s in history(f) for f in followers)]
            # every validated ledger, adopted by both followers
            assert both == list(range(2, common + 1)), (both, common)
            answers = {}
            for f in followers:
                out = []
                for s in both:
                    out.append(call(f, "ledger", ledger_index=s))
                    out.append(call(f, "account_info", account=dests[0].human_account_id,
                                    ledger_index=s))
                out.append(call(f, "account_tx", account=dests[0].human_account_id,
                                ledger_index_min=1, ledger_index_max=common))
                # selector-less: the follower's validated snapshot
                snap = call(f, "account_info", account=dests[2].human_account_id)
                assert snap["ledger_index"] == f.read_plane.snapshot().seq
                answers[f.pkg] = [scrub(a, VOLATILE) for a in out]
            assert answers["port"] == answers["jax"]
            assert not any("error" in a for a in answers["port"][-1:])
            assert len(answers["port"][-1]["transactions"]) == 2
        finally:
            net.stop()


def shard_files(node) -> dict:
    """(lo, hi) -> the bytes of each shard file an archive holds."""
    out = {}
    for sh in node.shardstore.shards():
        path = os.path.join(node.shardstore.root, f"shard-{sh['id']:06d}.shard")
        with open(path, "rb") as f:
            out[(sh["lo"], sh["hi"])] = f.read()
    return out


def test_archives_backfill_across_the_packages(tmp_path):
    with deadline(300):
        net = FleetNet(tmp_path, "fleet-a", sealers=SEALERS)
        try:
            sealers = [net.validators[i] for i in SEALERS]
            dests = [KeyPair.from_passphrase(f"fleet-a-dest-{i}") for i in range(2)]
            seq = 1
            t_end = time.monotonic() + 150
            # traffic until both sealers hold two shards below their floor
            while not all(len(v.shardstore.shards()) >= 2 for v in sealers):
                assert time.monotonic() < t_end, [
                    (validated(v), v.shardstore.shards()) for v in sealers]
                if all(validated(n) >= 2 for n in net.validators):
                    seq = submit_payments(net.validators[seq % 2], dests, seq, 300 * XRP)
                    time.sleep(1.0)
                time.sleep(0.2)
            archives = {
                "port": net.join("port", "ap", "archive", upstream=0, archive_rescan_s=2.0),
                "jax": net.join("jax", "aj", "archive", upstream=1, archive_rescan_s=2.0),
            }
            source = {"port": net.validators[0], "jax": net.validators[1]}

            def backfilled():
                return all(
                    {(sh["lo"], sh["hi"]) for sh in source[k].shardstore.shards()[:2]}
                    <= set(shard_files(a)) for k, a in archives.items())

            assert wait_until(backfilled, 120), {
                k: (a.overlay.node.shard_backfill.get_json(), a.shardstore.shards())
                for k, a in archives.items()}
            for k, a in archives.items():
                sb = a.overlay.node.shard_backfill.get_json()
                assert sb["imported"] >= 2 and sb["garbage_peers"] == 0, (k, sb)
                assert sb["import_rejects"] == 0
                assert a.shardstore.contiguous_floor() > 0
                assert a.read_plane.archive_floor == a.shardstore.contiguous_floor()
                # the archive's files are its upstream's, byte for byte
                for rng, blob in shard_files(a).items():
                    src = shard_files(source[k])
                    if rng in src:
                        assert src[rng] == blob, (k, rng)
            files = {k: shard_files(a) for k, a in archives.items()}
            common = sorted(set(files["port"]) & set(files["jax"]))
            assert common, {k: sorted(f) for k, f in files.items()}
            for rng in common:
                assert files["port"][rng] == files["jax"][rng], rng
            # deep reads below the validators' retained floor: equal
            floor = min(v.txdb.retain_floor for v in sealers)
            lo, hi = common[0]
            assert hi < floor, (common, floor)
            answers = {}
            for k, a in archives.items():
                out = [call(a, "ledger", ledger_index=s) for s in range(lo, hi + 1)]
                out += [call(a, "account_tx", account=KeyPair.from_passphrase(
                    "masterpassphrase").human_account_id, ledger_index_min=lo,
                    ledger_index_max=hi, forward=True)]
                answers[k] = [scrub(x, VOLATILE) for x in out]
            assert answers["port"] == answers["jax"]
            assert not any("error" in x for x in answers["port"])
            assert answers["port"][0]["ledger"]["hash"].lower() == next(
                sh for sh in source["port"].shardstore.shards()
                if sh["lo"] == lo)["first_hash"].lower()
        finally:
            net.stop()
