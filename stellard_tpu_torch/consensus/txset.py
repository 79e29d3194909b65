"""TxSet: a consensus candidate transaction set.

The reference represents a position's tx set as a SHAMap of raw tx blobs
keyed by txid (LedgerConsensus's mAcquired/mOurPosition maps); the set's
identity is the map's root hash, which is what proposals carry. We reuse
the SHAMap so the set hash is computed by the same level-batched
BatchHasher pipeline as the ledger trees.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

from ..protocol.sttx import SerializedTransaction
from ..state.shamap import SHAMap, SHAMapItem, TNType

__all__ = ["TxSet", "MAX_TXSET_BLOBS"]

# defense cap on a relayed candidate set: a byzantine peer must not buy
# unbounded parse/hash work with one TxSetData message. Generous — the
# 4x-overload bench closes ~3k-tx ledgers; an honest set stays far under.
MAX_TXSET_BLOBS = 8192


class TxSet:
    def __init__(self, hash_batch: Optional[Callable] = None):
        if hash_batch is not None:
            self._map = SHAMap(leaf_type=TNType.TX_NM, hash_batch=hash_batch)
        else:
            self._map = SHAMap(leaf_type=TNType.TX_NM)
        self._txs: dict[bytes, bytes] = {}  # txid -> blob

    @classmethod
    def from_transactions(
        cls,
        txs: list[SerializedTransaction],
        hash_batch: Optional[Callable] = None,
    ) -> "TxSet":
        s = cls(hash_batch)
        for tx in txs:
            s.add(tx.txid(), tx.serialize())
        return s

    def add(self, txid: bytes, blob: bytes) -> None:
        self._txs[txid] = blob
        self._map.set_item(SHAMapItem(txid, blob))

    def remove(self, txid: bytes) -> None:
        if txid in self._txs:
            del self._txs[txid]
            self._map.del_item(txid)

    def __contains__(self, txid: bytes) -> bool:
        return txid in self._txs

    def __len__(self) -> int:
        return len(self._txs)

    def get(self, txid: bytes) -> Optional[bytes]:
        return self._txs.get(txid)

    def txids(self) -> set[bytes]:
        return set(self._txs)

    def blobs(self) -> Iterator[tuple[bytes, bytes]]:
        return iter(sorted(self._txs.items()))

    def hash(self) -> bytes:
        return self._map.get_hash()

    def copy(self) -> "TxSet":
        c = TxSet(self._map.hash_batch)
        for txid, blob in self._txs.items():
            c.add(txid, blob)
        return c

    def differences(self, other: "TxSet") -> set[bytes]:
        """Txids present in exactly one of the two sets — each becomes a
        DisputedTx (reference: LedgerConsensus::createDisputes via
        SHAMap::compare)."""
        return self.txids() ^ other.txids()

    def transactions(self) -> list[SerializedTransaction]:
        return [
            SerializedTransaction.from_bytes(blob)
            for _txid, blob in self.blobs()
        ]

    def __repr__(self):
        return f"TxSet(n={len(self)} hash={self.hash().hex()[:8]})"
