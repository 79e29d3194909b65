"""Server-side transaction signing with autofill.

Reference: src/ripple_rpc/impl/TransactionSign.cpp — transactionSign
(:180) builds an STTx from tx_json, auto-fills Fee (load-scaled),
Sequence (from the open-ledger account state) and Flags, derives the
keypair from `secret`, signs, and optionally submits (:380).
"""

from __future__ import annotations

from ..protocol.keys import KeyPair, decode_seed, passphrase_to_seed
from ..protocol.sfields import (
    sfFee,
    sfSequence,
    sfSigningPubKey,
)
from ..protocol.stamount import STAmount
from ..protocol.stparsedjson import JsonParseError, parse_tx_json
from ..protocol.sttx import SerializedTransaction
from .errors import RPCError

__all__ = ["keypair_from_secret", "transaction_sign"]


def keypair_from_secret(secret: str) -> KeyPair:
    """A secret is a base58 seed (s...) or a passphrase (reference:
    RippleAddress::setSeedGeneric)."""
    try:
        return KeyPair.from_seed(decode_seed(secret))
    except (ValueError, KeyError):
        pass
    return KeyPair.from_seed(passphrase_to_seed(secret))


def transaction_sign(
    node, tx_json: dict, secret: str, build_path: bool = False
) -> SerializedTransaction:
    """Build + autofill + sign. Raises RPCError on malformed input.
    With build_path, a pathless cross-currency Payment gets a pathfinder
    path set attached (reference: TransactionSign.cpp bPath branch)."""
    if not isinstance(tx_json, dict):
        raise RPCError("invalidParams", "tx_json is not an object")
    if "Account" not in tx_json:
        raise RPCError("srcActMissing")
    try:
        obj = parse_tx_json(tx_json)
    except JsonParseError as exc:
        raise RPCError("invalidTransaction", str(exc)) from exc

    key = keypair_from_secret(secret)
    tx = SerializedTransaction(obj)

    ledger = node.ledger_master.current_ledger()

    # autofill Paths (reference: TransactionSign.cpp:195-224 — only for
    # a Payment that is not a plain native transfer and carries none)
    from ..protocol.formats import TxType as _TT
    from ..protocol.sfields import (
        sfAmount as _amt,
        sfDestination as _dst,
        sfPaths as _paths,
        sfSendMax as _smax,
        sfTransactionType as _tt,
    )

    if (
        build_path
        and obj.get(_tt) == int(_TT.ttPAYMENT)
        and _paths not in obj
    ):
        if _amt not in obj or _dst not in obj:
            raise RPCError(
                "invalidTransaction",
                "Payment needs Amount and Destination",
            )
        amount = obj[_amt]
        if not (amount.is_native and _smax not in obj):
            from ..paths.pathfinder import build_path_set
            from ..protocol.stobject import STPathSet

            found = build_path_set(
                ledger, tx.account, obj[_dst], amount,
                send_max=obj.get(_smax),
            )
            if found:
                obj[_paths] = STPathSet(found)

    # autofill Fee (reference: TransactionSign.cpp:225-240, load-scaled)
    if sfFee not in obj:
        obj[sfFee] = STAmount.from_drops(
            ledger.scale_fee_load(ledger.base_fee)
        )
    # autofill Sequence from the account root, bumped past any queued
    # open-ledger txns from the same account (reference :268-290)
    if sfSequence not in obj:
        acct = ledger.account_root(tx.account)
        if acct is None:
            raise RPCError("actNotFound", account=tx_json.get("Account"))
        from ..protocol.sfields import sfSequence as _seq

        obj[sfSequence] = predicted_sequence(ledger, tx.account, acct[_seq])

    # the secret must control the source account (master key path; regular
    # -key signing passes key authority checks at apply time)
    tx.sign(key)
    ok, why = tx.passes_local_checks()
    if not ok:
        raise RPCError("invalidTransaction", why)
    return tx


def predicted_sequence(ledger, account: bytes, account_seq: int) -> int:
    """Next usable sequence: account-root seq bumped past any queued
    open-ledger txns (reference walks the open tx map; here the ledger's
    per-account cache makes it O(1))."""
    cached = ledger.open_tx_seqs.get(account)
    if cached is not None and cached + 1 > account_seq:
        return cached + 1
    return account_seq
