"""Ledger state: the SHAMap the seal hashes, the ledger and its entry set."""

from .shamap import SHAMap, SHAMapItem, TNType
from .ledger import Ledger
from .entryset import LedgerEntrySet

__all__ = ["SHAMap", "SHAMapItem", "TNType", "Ledger", "LedgerEntrySet"]
