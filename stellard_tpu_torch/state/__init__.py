"""Ledger state: the SHAMap the seal hashes."""
