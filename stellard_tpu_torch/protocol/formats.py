"""Transaction and ledger-entry format tables.

Protocol constants shared with the reference
(src/ripple_data/protocol/TxFormats.{h,cpp},
LedgerFormats.{h,cpp}): each format names its type code and the
required/optional field template (SOTemplate).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from . import sfields as sf
from .sfields import SField


class SOE(IntEnum):
    """Field presence classes (SerializedObjectTemplate.h:29-34)."""

    REQUIRED = 0
    OPTIONAL = 1
    DEFAULT = 2  # optional; if present must not hold the default value


class TxType(IntEnum):
    """Transaction type codes (reference TxFormats.h:33-53)."""

    ttPAYMENT = 0
    ttINFLATION = 1
    ttWALLET_ADD = 2
    ttACCOUNT_SET = 3
    ttACCOUNT_MERGE = 4
    ttREGULAR_KEY_SET = 5
    ttNICKNAME_SET = 6
    ttOFFER_CREATE = 7
    ttOFFER_CANCEL = 8
    ttCONTRACT = 9
    ttCONTRACT_REMOVE = 10
    ttTRUST_SET = 20
    ttAMENDMENT = 100
    ttFEE = 101


class LedgerEntryType(IntEnum):
    """Ledger entry type codes (reference LedgerFormats.h:38-72)."""

    ltACCOUNT_ROOT = ord("a")
    ltDIR_NODE = ord("d")
    ltGENERATOR_MAP = ord("g")
    ltNICKNAME = ord("n")
    ltRIPPLE_STATE = ord("r")
    ltOFFER = ord("o")
    ltCONTRACT = ord("c")
    ltLEDGER_HASHES = ord("h")
    ltAMENDMENTS = ord("f")
    ltFEE_SETTINGS = ord("s")


@dataclass(frozen=True)
class Format:
    name: str
    type_code: int
    template: tuple[tuple[SField, SOE], ...]

    # built once per (immutable) format: these sit on the per-tx apply
    # hot path via validate_against, where a rebuilt set per call was
    # measurable at flood rates
    def known_fields(self) -> frozenset[SField]:
        cached = self.__dict__.get("_known")
        if cached is None:
            cached = frozenset(f for f, _ in self.template)
            object.__setattr__(self, "_known", cached)
        return cached

    def required_fields(self) -> frozenset[SField]:
        cached = self.__dict__.get("_required")
        if cached is None:
            cached = frozenset(
                f for f, soe in self.template if soe == SOE.REQUIRED
            )
            object.__setattr__(self, "_required", cached)
        return cached


def _fmt(name: str, code: int, elems: list[tuple[SField, SOE]]) -> Format:
    return Format(name, code, tuple(elems))


# Common fields present on every transaction (reference
# TxFormats::addCommonFields, TxFormats.cpp:97-115).
TX_COMMON_FIELDS: list[tuple[SField, SOE]] = [
    (sf.sfTransactionType, SOE.REQUIRED),
    (sf.sfFlags, SOE.OPTIONAL),
    (sf.sfSourceTag, SOE.OPTIONAL),
    (sf.sfAccount, SOE.REQUIRED),
    (sf.sfSequence, SOE.REQUIRED),
    (sf.sfPreviousTxnID, SOE.OPTIONAL),  # deprecated
    (sf.sfLastLedgerSequence, SOE.OPTIONAL),
    (sf.sfAccountTxnID, SOE.OPTIONAL),
    (sf.sfFee, SOE.REQUIRED),
    (sf.sfOperationLimit, SOE.OPTIONAL),
    (sf.sfMemos, SOE.OPTIONAL),
    (sf.sfSigningPubKey, SOE.REQUIRED),
    (sf.sfTxnSignature, SOE.OPTIONAL),
]


def _tx(name: str, code: TxType, elems: list[tuple[SField, SOE]]) -> Format:
    return _fmt(name, int(code), TX_COMMON_FIELDS + elems)


# Transaction formats (reference TxFormats.cpp:22-95).
TX_FORMATS: dict[int, Format] = {
    f.type_code: f
    for f in [
        _tx("AccountSet", TxType.ttACCOUNT_SET, [
            (sf.sfTransferRate, SOE.OPTIONAL),
            (sf.sfSetFlag, SOE.OPTIONAL),
            (sf.sfClearFlag, SOE.OPTIONAL),
            (sf.sfInflationDest, SOE.OPTIONAL),
            (sf.sfSetAuthKey, SOE.OPTIONAL),
        ]),
        _tx("AccountMerge", TxType.ttACCOUNT_MERGE, [
            (sf.sfDestination, SOE.REQUIRED),
            (sf.sfDestinationTag, SOE.OPTIONAL),
        ]),
        _tx("TrustSet", TxType.ttTRUST_SET, [
            (sf.sfLimitAmount, SOE.OPTIONAL),
            (sf.sfQualityIn, SOE.OPTIONAL),
            (sf.sfQualityOut, SOE.OPTIONAL),
        ]),
        _tx("OfferCreate", TxType.ttOFFER_CREATE, [
            (sf.sfTakerPays, SOE.REQUIRED),
            (sf.sfTakerGets, SOE.REQUIRED),
            (sf.sfExpiration, SOE.OPTIONAL),
            (sf.sfOfferSequence, SOE.OPTIONAL),
        ]),
        _tx("OfferCancel", TxType.ttOFFER_CANCEL, [
            (sf.sfOfferSequence, SOE.REQUIRED),
        ]),
        _tx("SetRegularKey", TxType.ttREGULAR_KEY_SET, [
            (sf.sfRegularKey, SOE.OPTIONAL),
        ]),
        _tx("Payment", TxType.ttPAYMENT, [
            (sf.sfDestination, SOE.REQUIRED),
            (sf.sfAmount, SOE.REQUIRED),
            (sf.sfSendMax, SOE.OPTIONAL),
            (sf.sfPaths, SOE.DEFAULT),
            (sf.sfInvoiceID, SOE.OPTIONAL),
            (sf.sfDestinationTag, SOE.OPTIONAL),
        ]),
        _tx("Inflation", TxType.ttINFLATION, [
            (sf.sfInflateSeq, SOE.REQUIRED),
        ]),
        _tx("EnableAmendment", TxType.ttAMENDMENT, [
            (sf.sfAmendment, SOE.REQUIRED),
        ]),
        _tx("SetFee", TxType.ttFEE, [
            (sf.sfBaseFee, SOE.REQUIRED),
            (sf.sfReferenceFeeUnits, SOE.REQUIRED),
            (sf.sfReserveBase, SOE.REQUIRED),
            (sf.sfReserveIncrement, SOE.REQUIRED),
        ]),
    ]
}

TX_FORMATS_BY_NAME: dict[str, Format] = {f.name: f for f in TX_FORMATS.values()}

# Common fields on every ledger entry (reference
# LedgerFormats::addCommonFields: LedgerEntryType + Flags).
LE_COMMON_FIELDS: list[tuple[SField, SOE]] = [
    (sf.sfLedgerEntryType, SOE.REQUIRED),
    (sf.sfFlags, SOE.REQUIRED),
]


def _le(name: str, code: LedgerEntryType, elems: list[tuple[SField, SOE]]) -> Format:
    return _fmt(name, int(code), LE_COMMON_FIELDS + elems)


# Ledger entry formats (reference LedgerFormats.cpp:22-120).
LEDGER_FORMATS: dict[int, Format] = {
    f.type_code: f
    for f in [
        _le("AccountRoot", LedgerEntryType.ltACCOUNT_ROOT, [
            (sf.sfAccount, SOE.REQUIRED),
            (sf.sfSequence, SOE.REQUIRED),
            (sf.sfBalance, SOE.REQUIRED),
            (sf.sfOwnerCount, SOE.REQUIRED),
            (sf.sfPreviousTxnID, SOE.REQUIRED),
            (sf.sfPreviousTxnLgrSeq, SOE.REQUIRED),
            (sf.sfAccountTxnID, SOE.OPTIONAL),
            (sf.sfRegularKey, SOE.OPTIONAL),
            (sf.sfTransferRate, SOE.OPTIONAL),
            (sf.sfDomain, SOE.OPTIONAL),
            (sf.sfInflationDest, SOE.OPTIONAL),
            (sf.sfSetAuthKey, SOE.OPTIONAL),
        ]),
        _le("DirectoryNode", LedgerEntryType.ltDIR_NODE, [
            (sf.sfOwner, SOE.OPTIONAL),
            (sf.sfTakerPaysCurrency, SOE.OPTIONAL),
            (sf.sfTakerPaysIssuer, SOE.OPTIONAL),
            (sf.sfTakerGetsCurrency, SOE.OPTIONAL),
            (sf.sfTakerGetsIssuer, SOE.OPTIONAL),
            (sf.sfExchangeRate, SOE.OPTIONAL),
            (sf.sfIndexes, SOE.REQUIRED),
            (sf.sfRootIndex, SOE.REQUIRED),
            (sf.sfIndexNext, SOE.OPTIONAL),
            (sf.sfIndexPrevious, SOE.OPTIONAL),
        ]),
        _le("Offer", LedgerEntryType.ltOFFER, [
            (sf.sfAccount, SOE.REQUIRED),
            (sf.sfSequence, SOE.REQUIRED),
            (sf.sfTakerPays, SOE.REQUIRED),
            (sf.sfTakerGets, SOE.REQUIRED),
            (sf.sfBookDirectory, SOE.REQUIRED),
            (sf.sfBookNode, SOE.REQUIRED),
            (sf.sfOwnerNode, SOE.REQUIRED),
            (sf.sfPreviousTxnID, SOE.REQUIRED),
            (sf.sfPreviousTxnLgrSeq, SOE.REQUIRED),
            (sf.sfExpiration, SOE.OPTIONAL),
        ]),
        _le("RippleState", LedgerEntryType.ltRIPPLE_STATE, [
            (sf.sfBalance, SOE.REQUIRED),
            (sf.sfLowLimit, SOE.REQUIRED),
            (sf.sfHighLimit, SOE.REQUIRED),
            (sf.sfPreviousTxnID, SOE.REQUIRED),
            (sf.sfPreviousTxnLgrSeq, SOE.REQUIRED),
            (sf.sfLowNode, SOE.OPTIONAL),
            (sf.sfLowQualityIn, SOE.OPTIONAL),
            (sf.sfLowQualityOut, SOE.OPTIONAL),
            (sf.sfHighNode, SOE.OPTIONAL),
            (sf.sfHighQualityIn, SOE.OPTIONAL),
            (sf.sfHighQualityOut, SOE.OPTIONAL),
        ]),
        _le("LedgerHashes", LedgerEntryType.ltLEDGER_HASHES, [
            (sf.sfLastLedgerSequence, SOE.OPTIONAL),
            (sf.sfHashes, SOE.REQUIRED),
        ]),
        _le("EnabledAmendments", LedgerEntryType.ltAMENDMENTS, [
            (sf.sfAmendments, SOE.REQUIRED),
        ]),
        _le("FeeSettings", LedgerEntryType.ltFEE_SETTINGS, [
            (sf.sfBaseFee, SOE.REQUIRED),
            (sf.sfReferenceFeeUnits, SOE.REQUIRED),
            (sf.sfReserveBase, SOE.REQUIRED),
            (sf.sfReserveIncrement, SOE.REQUIRED),
        ]),
    ]
}

LEDGER_FORMATS_BY_NAME: dict[str, Format] = {f.name: f for f in LEDGER_FORMATS.values()}


def validate_against(obj, fmt: Format) -> list[str]:
    """Template check: required fields present, no unknown fields.
    Returns a list of problems (empty = valid)."""
    problems = []
    known = fmt.known_fields()
    present = {f for f, _ in obj.fields()}
    for f in fmt.required_fields():
        if f not in present:
            problems.append(f"missing required field {f.name}")
    for f in present:
        if f not in known:
            problems.append(f"unknown field {f.name} for {fmt.name}")
    return problems
