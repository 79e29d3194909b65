"""A private net of four port validator processes over real sockets:
each is ``python -m stellard_tpu_torch --conf <ini> --start`` on the
INI of ``stellard_tpu_torch.testkit.tcpnet.validator_config`` (the JAX
package's private-net template: UNL of the other three, their
addresses, quorum 3, ``[peer_ssl] require``, a memory node store), with
``type=cpu`` crypto planes.

- ``test_four_port_processes_close_agree_and_commit_a_payment`` (tier
  1, its own 120 s deadline): the four processes mesh, close and agree
  on every validated hash, and a payment submitted over RPC at one of
  them commits on all four.
- ``test_multiproc_net_port_twin`` (slow, as its original is): every
  test of tests/test_multiproc_net.py on its port twin — the module's
  source with the package, the launched module and the template read as
  the port's — run by pytest in a subprocess.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from stellard_tpu_torch.protocol.keys import KeyPair
from stellard_tpu_torch.testkit.tcpnet import (
    free_ports,
    rpc,
    spawn_validator,
    validator_config,
    wait_until,
)
from test_torch_tcp import deadline

TESTS = Path(__file__).resolve().parent
N = 4


@pytest.fixture()
def port_net(tmp_path):
    ports = free_ports(3 * N)
    peer_ports, rpc_ports, ws_ports = ports[:N], ports[N:2 * N], ports[2 * N:]
    keys = [KeyPair.from_passphrase(f"mp-val-{i}") for i in range(N)]
    procs, logs = [], []
    for i in range(N):
        cfg = tmp_path / f"validator-{i}.cfg"
        cfg.write_text(validator_config(i, keys, peer_ports, rpc_ports[i], ws_ports[i]))
        logs.append(tmp_path / f"validator-{i}.log")
        procs.append(spawn_validator(str(cfg), stdout=logs[-1].open("w")))
    try:
        yield {"rpc_ports": rpc_ports, "procs": procs, "logs": logs}
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def validated_seqs(rpc_ports) -> list:
    return [rpc(p, "server_info")["info"]["validated_ledger"]["seq"] for p in rpc_ports]


def test_four_port_processes_close_agree_and_commit_a_payment(port_net):
    rpc_ports = port_net["rpc_ports"]
    tails = lambda: [p.read_text()[-2000:] for p in port_net["logs"]]  # noqa: E731
    with deadline(120):
        assert wait_until(
            lambda: all(rpc(p, "server_info")["info"]["peers"] == 3 for p in rpc_ports),
            timeout=60), tails()
        assert wait_until(lambda: min(validated_seqs(rpc_ports)) >= 3, timeout=40), tails()
        common = min(validated_seqs(rpc_ports))
        for seq in range(2, common + 1):
            hashes = {rpc(p, "ledger", {"ledger_index": seq})["ledger"]["hash"]
                      for p in rpc_ports}
            assert len(hashes) == 1, f"fork at seq {seq}: {hashes}"

        alice = KeyPair.from_passphrase("mp-alice")
        amount = 5_000 * 1_000_000
        res = rpc(rpc_ports[0], "submit", {
            "secret": "masterpassphrase",
            "tx_json": {"TransactionType": "Payment",
                        "Account": KeyPair.from_passphrase("masterpassphrase").human_account_id,
                        "Destination": alice.human_account_id, "Amount": str(amount)},
        }, timeout=15.0)
        assert res["engine_result"] in ("tesSUCCESS", "terQUEUED"), res

        def landed():
            return all(
                int(rpc(p, "account_info", {"account": alice.human_account_id,
                                            "ledger_index": "validated"})
                    ["account_data"]["Balance"]) == amount
                for p in rpc_ports)

        assert wait_until(landed, timeout=40), tails()
        assert all(p.poll() is None for p in port_net["procs"]), tails()


def multiproc_twin_source() -> str:
    """tests/test_multiproc_net.py read as the port's: its package, the
    module it launches, and its template's crypto planes (the port's
    hash plane defaults to the card; the JAX one's to the host)."""
    src = (TESTS / "test_multiproc_net.py").read_text()
    for old, new in (
        ("stellard_tpu.", "stellard_tpu_torch."),
        ('"-m", "stellard_tpu",', '"-m", "stellard_tpu_torch",'),
        ("[signature_backend]\ntype=cpu\n", "[signature_backend]\ntype=cpu\n\n"
                                             "[hash_backend]\ntype=cpu\n"),
        ("REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))",
         f"REPO = {str(TESTS.parent)!r}"),
    ):
        assert old in src, old
        src = src.replace(old, new)
    return src


def test_multiproc_twin_reads_as_the_port():
    src = multiproc_twin_source()
    assert "stellard_tpu." not in src and '"stellard_tpu",' not in src
    assert "[hash_backend]\ntype=cpu" in src


@pytest.mark.slow
def test_multiproc_net_port_twin(tmp_path):
    twin = tmp_path / "test_multiproc_net_port.py"
    twin.write_text(multiproc_twin_source())
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(TESTS), str(TESTS.parent)])}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", str(twin), "-q", "-m", "slow", "-p", "no:cacheprovider",
         "--rootdir", str(tmp_path)],
        cwd=str(TESTS), env=env, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
