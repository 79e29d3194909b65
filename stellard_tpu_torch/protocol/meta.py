"""Transaction-metadata helpers.

Reference: src/ripple_data/protocol/TransactionMeta.cpp —
getAffectedAccounts walks every field of the affected nodes collecting
account IDs (including IOU issuers), which feeds both the
AccountTransactions SQL index and account-subscription pub/sub routing.
"""

from __future__ import annotations

from .sfields import STI
from .stamount import ACCOUNT_ZERO, STAmount
from .stobject import STArray, STObject

__all__ = ["affected_accounts"]


def affected_accounts(meta_blob: "bytes | STObject") -> list[bytes]:
    # accepts the already-parsed meta object when the caller has one
    # in hand (the close path builds it; re-parsing per tx at persist
    # was ~8% of the flood apply path)
    meta = (meta_blob if isinstance(meta_blob, STObject)
            else STObject.from_bytes(meta_blob))
    out: set[bytes] = set()

    def walk(obj: STObject) -> None:
        for f, v in obj.fields():
            if f.type_id == STI.ACCOUNT:
                out.add(v)
            elif isinstance(v, STAmount) and not v.is_native:
                if v.issuer != ACCOUNT_ZERO:
                    out.add(v.issuer)
            elif isinstance(v, STObject):
                walk(v)
            elif isinstance(v, STArray):
                for _, inner in v:
                    walk(inner)

    walk(meta)
    return sorted(out)
