"""Node: the persist-side helpers of the application container.

Reference: src/ripple_app/main/Application.cpp. The ``Node`` class (the
wiring of storage, crypto plane, executor, ledger chain and API doors)
comes with the standalone node (ROADMAP Queue A item 4). What the close
path needs of it is here already: ``build_tx_rows``, which the chain's
``LedgerMaster.persist_prep`` runs beside the threaded seal, and
``_results_from_meta``, the close pipeline's ``recover_results`` for
ledgers that were never applied locally.
"""

from __future__ import annotations

from typing import Optional

from ..protocol.ter import TER
from ..state.ledger import Ledger

__all__ = ["build_tx_rows"]


def _results_from_meta(ledger: Ledger) -> dict:
    """{txid: TER} recovered from each committed tx's sfTransactionResult
    metadata byte — for ledgers adopted from the net (never applied
    locally, so no local results exist)."""
    from ..protocol.sfields import sfTransactionResult
    from ..protocol.stobject import STObject

    out = {}
    for txid, _blob, meta in ledger.tx_entries():
        if not meta:
            continue
        try:
            code = STObject.from_bytes(meta).get(sfTransactionResult)
            if code is not None:
                out[txid] = TER(code)
        except Exception:  # noqa: BLE001 — unparseable meta: skip this tx
            continue
    return out


def build_tx_rows(ledger: Ledger, results: dict) -> list[tuple]:
    """Materialize a closed ledger's txdb rows, reusing the close pass's
    parsed_txs/parsed_metas memos instead of re-parsing blobs. Pure
    Python tail work: close_and_advance runs it overlapped with the seal
    tree-hash (LedgerMaster.persist_prep), and the close pipeline's txdb
    stage falls back to it for adopted/repaired ledgers."""
    from ..protocol.meta import affected_accounts

    rows = []
    for txn_seq, (txid, blob, meta) in enumerate(ledger.tx_entries()):
        tx = ledger.parse_tx(txid, blob)
        meta_src = ledger.parsed_metas.get(txid, meta)
        affected = affected_accounts(meta_src) if meta else [tx.account]
        rows.append((
            txid,
            tx.tx_type.name,
            tx.account,
            tx.sequence,
            ledger.seq,
            _result_token(txid, results, meta),
            blob,
            meta,
            affected,
            txn_seq,
        ))
    return rows


def _result_token(txid: bytes, results: dict, meta: Optional[bytes]) -> str:
    """TER token for a committed tx: the local apply result when we
    closed the round ourselves, else the sfTransactionResult byte from
    the tx metadata (catch-up-adopted ledgers were not applied locally,
    and recording a blanket tesSUCCESS would misreport tec-class txs)."""
    if txid in results:
        return TER(results[txid]).token
    if meta:
        try:
            from ..protocol.sfields import sfTransactionResult
            from ..protocol.stobject import STObject

            code = STObject.from_bytes(meta).get(sfTransactionResult)
            if code is not None:
                return TER(code).token
        except Exception:  # noqa: BLE001 — unparseable meta: fall through
            pass
    return TER.tesSUCCESS.token
