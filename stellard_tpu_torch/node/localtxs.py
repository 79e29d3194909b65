"""LocalTxs: locally-submitted transactions re-applied across ledgers.

Role parity with src/ripple_app/tx/LocalTxs.cpp: a
transaction a client handed to THIS node must not vanish just because
one consensus round left it out — it re-applies to every successive open
ledger until it lands in a validated ledger, permanently fails, or
expires (a bounded number of ledgers past submission, the reference's
holdLedgers role).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER

__all__ = ["LocalTxs"]

HOLD_LEDGERS = 5  # retry horizon past the submission ledger


class _LocalTx:
    __slots__ = ("tx", "submit_seq", "failed")

    def __init__(self, tx: SerializedTransaction, submit_seq: int):
        self.tx = tx
        self.submit_seq = submit_seq
        self.failed = False

    def expired(self, ledger_seq: int) -> bool:
        return ledger_seq > self.submit_seq + HOLD_LEDGERS


class LocalTxs:
    def __init__(self):
        self._lock = threading.Lock()
        self._txns: dict[bytes, _LocalTx] = {}
        self.reapplied = 0

    def push_back(self, ledger_seq: int, tx: SerializedTransaction) -> None:
        """Track a locally-submitted tx (reference push_back). A
        RE-submission of a known txid revives the entry — it must not be
        shadowed by a stale `failed` mark or an old retry horizon (a tx
        queued by the admission plane and later evicted is resubmitted
        by the client with the same txid; the old setdefault left the
        original entry in place, permanently un-retriable once failed)."""
        with self._lock:
            cur = self._txns.get(tx.txid())
            if cur is None:
                self._txns[tx.txid()] = _LocalTx(tx, ledger_seq)
            else:
                cur.failed = False
                cur.submit_seq = max(cur.submit_seq, ledger_seq)

    def rebase(self, ledger_seq: int) -> int:
        """Fresh retry horizon for every tracked tx, used at fork repair
        (LCL switch): the expiry horizon counts ledgers on the chain a
        tx could have been INCLUDED in — after adopting the network's
        chain (whose seq may be far past submit_seq + HOLD_LEDGERS), a
        client tx submitted to the losing side must get its HOLD_LEDGERS
        retries against the authoritative chain, not be silently expired
        by a seq jump it never saw. Returns entries rebased."""
        with self._lock:
            for item in self._txns.values():
                item.submit_seq = max(item.submit_seq, ledger_seq)
            return len(self._txns)

    def remove(self, txid: bytes) -> bool:
        """Stop tracking a tx (wired as TxQ.on_drop: admission-queue
        eviction / expiry / promote-drop): the queue's drop decision
        must also stop the cross-round re-apply, and the next client
        resubmission starts a fresh retry horizon."""
        with self._lock:
            return self._txns.pop(txid, None) is not None

    def __contains__(self, txid: bytes) -> bool:
        with self._lock:
            return txid in self._txns

    def __len__(self) -> int:
        with self._lock:
            return len(self._txns)

    def apply_to_open(self, ledger_master, engine_params) -> int:
        """Re-apply survivors to the current open ledger (reference
        LocalTxsImp::apply, driven after each consensus accept). Returns
        the number re-applied."""
        with self._lock:
            items = [t for t in self._txns.values() if not t.failed]
        n = 0
        for item in items:
            ter, _applied = ledger_master.do_transaction(
                item.tx, engine_params
            )
            if ter.is_tem or ter.is_tec:
                # malformed or claimed-fee failure: no future retry
                with self._lock:
                    cur = self._txns.get(item.tx.txid())
                    if cur is not None:
                        cur.failed = True
            else:
                n += 1
        self.reapplied += n
        return n

    def sweep(self, validated_ledger) -> int:
        """Drop txns that made a validated ledger or expired (reference
        sweep with mSweepLedgers). Returns the number dropped."""
        dropped = 0
        in_ledger = set()
        for txid, _blob, _meta in validated_ledger.tx_entries():
            in_ledger.add(txid)
        with self._lock:
            for txid in list(self._txns):
                item = self._txns[txid]
                if txid in in_ledger or item.expired(validated_ledger.seq):
                    del self._txns[txid]
                    dropped += 1
        return dropped

    def get_json(self) -> dict:
        with self._lock:
            return {"count": len(self._txns), "reapplied": self.reapplied}
