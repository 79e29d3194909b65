"""Transaction engine: typed transactors applying signed transactions to a
ledger through a LedgerEntrySet.

Reference scope: src/ripple_app/tx (TransactionEngine),
src/ripple_app/transactors (Transactor pipeline + per-type transactors).
Only the Payment transactor is registered; the JAX package's other types
raise NotImplementedError (transactor._NOT_PORTED).
"""

from .engine import TransactionEngine, TxParams
from .transactor import Transactor, make_transactor
from . import payment  # noqa: F401

__all__ = ["TransactionEngine", "TxParams", "Transactor", "make_transactor"]
