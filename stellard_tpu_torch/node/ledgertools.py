"""The batched verify seam between the verify plane and transactions.

Reference shape: the JAX package's ``node/ledgertools.py``
``_reverify_memoized`` — every signature of a transaction list verified
in ONE batched call, each verdict memoized into its transaction (the
HashRouter SF_SIGGOOD seam), so the engine's ``Transactor.pre_check``
reads the verdict instead of verifying on the host. The dump, stream and
replay tools of that module are not part of this package yet.
"""

from __future__ import annotations

from typing import Callable

from ..crypto.backend import VerifyRequest
from .hashrouter import SF_SIGGOOD

__all__ = ["_reverify_memoized"]


def _reverify_memoized(txs: list, verify_many: Callable, router=None) -> list[bool]:
    """Verify `txs`' signatures with one ``verify_many`` call (a
    ``VerifyPlane.verify_many``: one K1 launch per chunk), set each tx's
    verdict, and with a ``router`` (HashRouter) flag the good ones
    SF_SIGGOOD. Returns the verdicts."""
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
