"""Consensus plane: timing rules, validations, proposals, disputed-tx
voting, and the per-round LedgerConsensus state machine.

Reference: src/ripple_app/consensus/ (LedgerConsensus.cpp, DisputedTx.cpp),
src/ripple_app/ledger/{LedgerTiming,SerializedValidation,LedgerProposal},
src/ripple_app/misc/Validations.cpp.
"""

from .consensus import ConsensusAdapter, ConsensusState, LedgerConsensus
from .disputed import DisputedTx
from .proposal import LedgerProposal
from .timing import (
    have_consensus,
    next_close_resolution,
    should_close,
)
from .txset import TxSet
from .validation import STValidation
from .validations import ValidationsStore

__all__ = [
    "ConsensusAdapter",
    "ConsensusState",
    "DisputedTx",
    "LedgerConsensus",
    "LedgerProposal",
    "STValidation",
    "TxSet",
    "ValidationsStore",
    "have_consensus",
    "next_close_resolution",
    "should_close",
]
