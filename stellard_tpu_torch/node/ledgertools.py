"""Offline ledger tooling: dump, transaction streams, and replay.

Reference: src/ripple_app/main/LedgerDump.cpp — `--dump_ledger` (:68),
`--dump_transactions` (:86), `--load_transactions` (:267) — plus the
`--ledger N --replay` path (Main.cpp:325-332): load a stored ledger and
re-close it from its parent, verifying the rebuilt hash bit-for-bit.

Replay is BASELINE config #5's harness: it re-runs the full pipeline —
batched signature verify (a ``VerifyPlane.verify_many``: K1), canonical
apply, metadata, and the tree re-hash through the chain's hasher (a
``CudaHasher``: K2/K3) — against known good output, and times it.

The shared batched-verify seam is ``_reverify_memoized``: every
signature of a transaction list verified in ONE ``verify_many`` call,
each verdict memoized into its transaction (the HashRouter SF_SIGGOOD
seam), so the engine's ``Transactor.pre_check`` reads the verdict
instead of verifying on the host.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Iterator, Optional, TextIO

from ..crypto.backend import VerifyRequest
from ..nodestore.core import Database
from ..protocol.stobject import STObject
from ..protocol.sttx import SerializedTransaction
from ..state.ledger import Ledger
from ..utils import gcpolicy
from .hashrouter import SF_SIGGOOD
from .ledgermaster import CanonicalTXSet, LedgerMaster

__all__ = [
    "dump_ledger",
    "dump_transactions",
    "load_transactions",
    "replay_ledger",
    "replay_range",
    "_reverify_memoized",
]


def dump_ledger(ledger: Ledger) -> dict:
    """Full JSON image of one closed ledger (reference: dumpLedger,
    LedgerDump.cpp:68 — header, state entries, transactions)."""
    out = {
        "ledger_index": ledger.seq,
        "ledger_hash": ledger.hash().hex().upper(),
        "parent_hash": ledger.parent_hash.hex().upper(),
        "close_time": ledger.close_time,
        "close_time_resolution": ledger.close_resolution,
        "close_flags": ledger.close_flags,
        "total_coins": str(ledger.tot_coins),
        "fee_pool": str(ledger.fee_pool),
        "inflation_seq": ledger.inflation_seq,
        "account_hash": ledger.state_map.get_hash().hex().upper(),
        "transaction_hash": ledger.tx_map.get_hash().hex().upper(),
        "accountState": [],
        "transactions": [],
    }
    for item in ledger.state_map.items():
        sle = STObject.from_bytes(item.data)
        j = sle.to_json()
        j["index"] = item.tag.hex().upper()
        out["accountState"].append(j)
    for txid, blob, _meta in ledger.tx_entries():
        tx = SerializedTransaction.from_bytes(blob)
        j = tx.obj.to_json()
        j["hash"] = txid.hex().upper()
        out["transactions"].append(j)
    return out


def dump_transactions(ledgers: Iterator[Ledger], fh: TextIO) -> int:
    """Stream every transaction of a ledger range as JSON lines
    (reference: dumpTransactions, LedgerDump.cpp:86). Format per line:
    {"ledger": seq, "close_time": t, "hash": txid, "blob": hex}."""
    n = 0
    for ledger in ledgers:
        for txid, blob, _meta in ledger.tx_entries():
            fh.write(
                json.dumps(
                    {
                        "ledger": ledger.seq,
                        "close_time": ledger.close_time,
                        "hash": txid.hex(),
                        "blob": blob.hex(),
                    }
                )
                + "\n"
            )
            n += 1
    return n


def load_transactions(
    fh: TextIO,
    lm: LedgerMaster,
    close_every: Optional[int] = None,
) -> tuple[int, int]:
    """Re-drive dumped transactions through a fresh chain (reference:
    loadTransactions, LedgerDump.cpp:267 — the bulk-import harness).
    Closes the open ledger whenever the source ledger seq changes (or
    every `close_every` txns). Returns (applied, failed)."""
    from ..engine.engine import TxParams

    applied = failed = 0
    last_src_ledger: Optional[int] = None
    last_close_time = 0
    pending = 0
    for line in fh:
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if last_src_ledger is not None and (
            rec["ledger"] != last_src_ledger
            or (close_every and pending >= close_every)
        ):
            # close with the batch's OWN close time (the previous
            # record's), not the next ledger's — time-dependent txns must
            # see the same clock they saw in the source chain
            lm.close_and_advance(last_close_time, 30)
            pending = 0
        last_src_ledger = rec["ledger"]
        last_close_time = rec["close_time"]
        tx = SerializedTransaction.from_bytes(bytes.fromhex(rec["blob"]))
        ter, ok = lm.do_transaction(tx, TxParams.OPEN_LEDGER | TxParams.RETRY)
        if ok or int(ter) == 0:
            applied += 1
        else:
            failed += 1
        pending += 1
    if pending:
        lm.close_and_advance(last_close_time, 30)
    return applied, failed


def _reverify_memoized(txs: list, verify_many: Callable, router=None) -> list[bool]:
    """Verify `txs`' signatures with one ``verify_many`` call (a
    ``VerifyPlane.verify_many``: one K1 launch per chunk), set each tx's
    verdict, and with a ``router`` (HashRouter) flag the good ones
    SF_SIGGOOD. The single shape of the catch-up trust model, shared by
    the close, per-ledger replay and bulk replay_range. Returns the
    verdicts."""
    if not txs:
        return []
    flags = verify_many([
        VerifyRequest(tx.signing_pub_key, tx.signing_hash(), tx.signature)
        for tx in txs
    ])
    verdicts = [bool(good) for good in flags]
    for tx, good in zip(txs, verdicts):
        tx.set_sig_verdict(good)
        if good and router is not None:
            router.set_flag(tx.txid(), SF_SIGGOOD)
    return verdicts


def replay_ledger(
    db: Database,
    ledger_hash: bytes,
    hash_batch: Optional[Callable] = None,
    verify_many: Optional[Callable] = None,
    _txs: Optional[list] = None,
    _target: Optional[Ledger] = None,
) -> dict:
    """Re-close a stored ledger from its parent and verify the result
    hashes identically (reference: --ledger N --replay, Main.cpp:325-332).

    Loads ledger L and parent P from the NodeStore, re-applies L's tx
    set to P in canonical order through the full engine, re-hashes both
    trees through `hash_batch` (a CudaHasher seals on the card: K2/K3),
    and compares against L's recorded hashes. Returns timing/throughput
    stats: ``elapsed_s`` from the verify to the seal, and apart from it
    the eager loads' ``load_s`` and the seal's ``seal_s``.

    With `verify_many` (a VerifyPlane-style batched verifier: K1), every
    tx signature in the ledger is re-verified in ONE batch up front and
    the verdicts memoized into the txs — the HashRouter SF_SIGGOOD seam —
    so the per-tx engine path skips its inline host verify. This is the
    catch-up trust model: replayed history is re-verified, batched."""
    kw = {"hash_batch": hash_batch} if hash_batch else {}
    t_load = time.perf_counter()
    target = _target if _target is not None else Ledger.load(
        db, ledger_hash, **kw
    )
    parent = Ledger.load(db, target.parent_hash, **kw)
    load_s = time.perf_counter() - t_load

    txs = _txs if _txs is not None else [
        SerializedTransaction.from_bytes(blob)
        for _txid, blob, _meta in target.tx_entries()
    ]
    t0 = time.perf_counter()
    if verify_many is not None:
        _reverify_memoized(txs, verify_many)
    replay = parent.open_successor()
    txset = CanonicalTXSet(parent.hash())
    for tx in txs:
        txset.insert(tx)
    lm = LedgerMaster(**kw)
    results = lm._apply_transactions(replay, txset)
    replay.close(
        target.close_time,
        target.close_resolution,
        correct_close_time=(target.close_flags & 1) == 0,
    )
    replay.close_flags = target.close_flags
    t_seal = time.perf_counter()
    replay_hash = replay.hash()
    seal_s = time.perf_counter() - t_seal
    elapsed = time.perf_counter() - t0

    ok = replay_hash == ledger_hash
    return {
        "ok": ok,
        "ledger_seq": target.seq,
        "tx_count": len(txs),
        "elapsed_s": elapsed,
        "tx_per_s": len(txs) / elapsed if elapsed > 0 else 0.0,
        "expected_hash": ledger_hash.hex(),
        "replayed_hash": replay_hash.hex(),
        "state_hash_ok": replay.state_map.get_hash()
        == target.state_map.get_hash(),
        "tx_hash_ok": replay.tx_map.get_hash() == target.tx_map.get_hash(),
        "results": {k.hex(): int(v) for k, v in results.items()},
        "load_s": load_s,
        "seal_s": seal_s,
    }


def replay_range(
    db: Database,
    ledger_hashes: list[bytes],
    hash_batch: Optional[Callable] = None,
    verify_many: Optional[Callable] = None,
) -> dict:
    """Bulk catch-up over a chain of stored ledgers.

    The reference re-verifies acquired history per ledger because its
    verify is a per-call host library (LedgerMaster/LedgerCleaner checks,
    libsodium); on a batch device every transaction signature across the
    whole range is verified in ONE ``verify_many`` up front (K1), then
    each ledger is re-applied with the verdicts memoized (the SF_SIGGOOD
    seam) — the bigger the catch-up span, the further the batch rides up
    the device's throughput curve. Verdict semantics are identical to
    per-ledger replay: a bad historic signature still fails its own
    ledger's hash check, no other's. Runs under the node's collector
    policy (utils/gcpolicy.py): the loaded trees are millions of
    long-lived objects."""
    with gcpolicy.held():
        return _replay_range(db, ledger_hashes, hash_batch, verify_many)


def _replay_range(db: Database, ledger_hashes: list[bytes],
                  hash_batch: Optional[Callable],
                  verify_many: Optional[Callable]) -> dict:
    kw = {"hash_batch": hash_batch} if hash_batch else {}
    t0 = time.perf_counter()
    targets = [Ledger.load(db, h, **kw) for h in ledger_hashes]
    load_s = time.perf_counter() - t0
    per_ledger: list[list[SerializedTransaction]] = [
        [
            SerializedTransaction.from_bytes(blob)
            for _txid, blob, _meta in target.tx_entries()
        ]
        for target in targets
    ]
    if verify_many is not None:
        _reverify_memoized(
            [tx for txs in per_ledger for tx in txs], verify_many
        )
    stats = [
        replay_ledger(db, h, hash_batch=hash_batch, _txs=txs,
                      _target=target)
        for h, txs, target in zip(ledger_hashes, per_ledger, targets)
    ]
    elapsed = time.perf_counter() - t0
    total = sum(s["tx_count"] for s in stats)
    return {
        "ok": all(s["ok"] for s in stats),
        "ledger_count": len(stats),
        "tx_count": total,
        "elapsed_s": elapsed,
        "tx_per_s": total / elapsed if elapsed > 0 else 0.0,
        "load_s": load_s,
        "ledgers": stats,
    }
