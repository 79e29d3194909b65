"""Transaction engine: typed transactors applying signed transactions to a
ledger through a LedgerEntrySet.

Reference scope: src/ripple_app/tx (TransactionEngine),
src/ripple_app/transactors (Transactor pipeline + per-type transactors).
"""

from .engine import TransactionEngine, TxParams
from .transactor import Transactor, make_transactor
from . import payment, trust, offers, account, inflation, change  # noqa: F401

__all__ = ["TransactionEngine", "TxParams", "Transactor", "make_transactor"]
