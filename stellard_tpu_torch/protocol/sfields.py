"""Typed field registry (SField equivalent).

Field codes are protocol constants shared with the reference wire format
(src/ripple_data/protocol/SerializeDeclarations.h). A field is identified by
(type id, field value); canonical serialization orders fields by that pair
(src/ripple_data/protocol/FieldNames.cpp SField::compare).
"""

from __future__ import annotations

from dataclasses import dataclass, field as _dc_field
from enum import IntEnum


class STI(IntEnum):
    """Serialized type ids (reference: SerializeDeclarations.h:33-49)."""

    NOTPRESENT = 0
    UINT16 = 1
    UINT32 = 2
    UINT64 = 3
    HASH128 = 4
    HASH256 = 5
    AMOUNT = 6
    VL = 7
    ACCOUNT = 8
    OBJECT = 14
    ARRAY = 15
    UINT8 = 16
    HASH160 = 17
    PATHSET = 18
    VECTOR256 = 19
    # high-level (never wire-encoded as field headers)
    TRANSACTION = 10001
    LEDGERENTRY = 10002
    VALIDATION = 10003


# encode-kind tags for the (de)serialization hot loops: integer compares
# instead of enum identity tests, precomputed once per registry field
K_UINT8, K_UINT16, K_UINT32, K_UINT64 = 0, 1, 2, 3
K_HASH, K_AMOUNT, K_VL, K_ACCOUNT = 4, 5, 6, 7
K_OBJECT, K_ARRAY, K_PATHSET, K_VECTOR256 = 8, 9, 10, 11

_KIND_OF = {
    STI.UINT8: K_UINT8, STI.UINT16: K_UINT16, STI.UINT32: K_UINT32,
    STI.UINT64: K_UINT64,
    STI.HASH128: K_HASH, STI.HASH160: K_HASH, STI.HASH256: K_HASH,
    STI.AMOUNT: K_AMOUNT, STI.VL: K_VL, STI.ACCOUNT: K_ACCOUNT,
    STI.OBJECT: K_OBJECT, STI.ARRAY: K_ARRAY, STI.PATHSET: K_PATHSET,
    STI.VECTOR256: K_VECTOR256,
}
_HASH_WIDTH_OF = {STI.HASH128: 16, STI.HASH160: 20, STI.HASH256: 32}
_INT_WIDTH_OF = {STI.UINT8: 1, STI.UINT16: 2, STI.UINT32: 4, STI.UINT64: 8}


def _field_header(type_id: int, value: int) -> bytes:
    """The constant field-id prefix (reference Serializer::addFieldID)."""
    if not (0 < type_id < 256 and 0 < value < 256):
        raise ValueError(f"bad field id ({type_id}, {value})")
    if type_id < 16:
        if value < 16:
            return bytes([(type_id << 4) | value])
        return bytes([type_id << 4, value])
    if value < 16:
        return bytes([value, type_id])
    return bytes([0, type_id, value])


@dataclass(frozen=True, eq=False)
class SField:
    """eq=False: fields are registry singletons, so identity equality /
    hashing is correct and keeps the per-field dict operations on the
    hot (de)serialization paths at object-id speed (the generated
    frozen-dataclass __hash__ tuples all four members per lookup)."""

    name: str
    type_id: STI
    value: int
    signing: bool = True  # excluded from signing serialization when False
    # wire constants for the hot paths, derived in __post_init__:
    header: bytes = b""  # the encoded field id (empty for non-wire types)
    kind: int = -1  # K_* tag, -1 for non-wire types
    width: int = 0  # fixed byte width for K_UINT*/K_HASH kinds
    cid: int = -1  # dense registry index (the native serializer's key)

    def __post_init__(self):
        k = _KIND_OF.get(self.type_id, -1)
        object.__setattr__(self, "kind", k)
        if k >= 0:
            object.__setattr__(
                self, "header", _field_header(int(self.type_id), self.value)
            )
        w = (_INT_WIDTH_OF.get(self.type_id, 0)
             or _HASH_WIDTH_OF.get(self.type_id, 0))
        object.__setattr__(self, "width", w)

    @property
    def code(self) -> int:
        return (int(self.type_id) << 16) | self.value

    def __repr__(self) -> str:
        return f"sf{self.name}"


_REGISTRY_BY_CODE: dict[int, SField] = {}
_REGISTRY_BY_NAME: dict[str, SField] = {}


def _f(name: str, type_id: STI, value: int, signing: bool = True) -> SField:
    f = SField(name, type_id, value, signing, cid=len(_REGISTRY_BY_CODE))
    _REGISTRY_BY_CODE[f.code] = f
    _REGISTRY_BY_NAME[name] = f
    return f


def all_fields():
    """Registry snapshot (the native serializer registers constants per
    field at load)."""
    return list(_REGISTRY_BY_CODE.values())


# --- 8-bit ---------------------------------------------------------------
sfCloseResolution = _f("CloseResolution", STI.UINT8, 1)
sfTemplateEntryType = _f("TemplateEntryType", STI.UINT8, 2)
sfTransactionResult = _f("TransactionResult", STI.UINT8, 3)

# --- 16-bit --------------------------------------------------------------
sfLedgerEntryType = _f("LedgerEntryType", STI.UINT16, 1)
sfTransactionType = _f("TransactionType", STI.UINT16, 2)

# --- 32-bit (common) -----------------------------------------------------
sfFlags = _f("Flags", STI.UINT32, 2)
sfSourceTag = _f("SourceTag", STI.UINT32, 3)
sfSequence = _f("Sequence", STI.UINT32, 4)
sfPreviousTxnLgrSeq = _f("PreviousTxnLgrSeq", STI.UINT32, 5)
sfLedgerSequence = _f("LedgerSequence", STI.UINT32, 6)
sfCloseTime = _f("CloseTime", STI.UINT32, 7)
sfParentCloseTime = _f("ParentCloseTime", STI.UINT32, 8)
sfSigningTime = _f("SigningTime", STI.UINT32, 9)
sfExpiration = _f("Expiration", STI.UINT32, 10)
sfTransferRate = _f("TransferRate", STI.UINT32, 11)
sfWalletSize = _f("WalletSize", STI.UINT32, 12)
sfOwnerCount = _f("OwnerCount", STI.UINT32, 13)
sfDestinationTag = _f("DestinationTag", STI.UINT32, 14)
# --- 32-bit (uncommon) ---------------------------------------------------
sfHighQualityIn = _f("HighQualityIn", STI.UINT32, 16)
sfHighQualityOut = _f("HighQualityOut", STI.UINT32, 17)
sfLowQualityIn = _f("LowQualityIn", STI.UINT32, 18)
sfLowQualityOut = _f("LowQualityOut", STI.UINT32, 19)
sfQualityIn = _f("QualityIn", STI.UINT32, 20)
sfQualityOut = _f("QualityOut", STI.UINT32, 21)
sfStampEscrow = _f("StampEscrow", STI.UINT32, 22)
sfBondAmount = _f("BondAmount", STI.UINT32, 23)
sfLoadFee = _f("LoadFee", STI.UINT32, 24)
sfOfferSequence = _f("OfferSequence", STI.UINT32, 25)
sfInflateSeq = _f("InflateSeq", STI.UINT32, 26)
sfLastLedgerSequence = _f("LastLedgerSequence", STI.UINT32, 27)
sfTransactionIndex = _f("TransactionIndex", STI.UINT32, 28)
sfOperationLimit = _f("OperationLimit", STI.UINT32, 29)
sfReferenceFeeUnits = _f("ReferenceFeeUnits", STI.UINT32, 30)
sfReserveBase = _f("ReserveBase", STI.UINT32, 31)
sfReserveIncrement = _f("ReserveIncrement", STI.UINT32, 32)
sfSetFlag = _f("SetFlag", STI.UINT32, 33)
sfClearFlag = _f("ClearFlag", STI.UINT32, 34)

# --- 64-bit --------------------------------------------------------------
sfIndexNext = _f("IndexNext", STI.UINT64, 1)
sfIndexPrevious = _f("IndexPrevious", STI.UINT64, 2)
sfBookNode = _f("BookNode", STI.UINT64, 3)
sfOwnerNode = _f("OwnerNode", STI.UINT64, 4)
sfBaseFee = _f("BaseFee", STI.UINT64, 5)
sfExchangeRate = _f("ExchangeRate", STI.UINT64, 6)
sfLowNode = _f("LowNode", STI.UINT64, 7)
sfHighNode = _f("HighNode", STI.UINT64, 8)

# --- 128-bit -------------------------------------------------------------
sfEmailHash = _f("EmailHash", STI.HASH128, 1)

# --- 256-bit (common) ----------------------------------------------------
sfLedgerHash = _f("LedgerHash", STI.HASH256, 1)
sfParentHash = _f("ParentHash", STI.HASH256, 2)
sfTransactionHash = _f("TransactionHash", STI.HASH256, 3)
sfAccountHash = _f("AccountHash", STI.HASH256, 4)
sfPreviousTxnID = _f("PreviousTxnID", STI.HASH256, 5)
sfLedgerIndex = _f("LedgerIndex", STI.HASH256, 6)
sfWalletLocator = _f("WalletLocator", STI.HASH256, 7)
sfRootIndex = _f("RootIndex", STI.HASH256, 8)
sfAccountTxnID = _f("AccountTxnID", STI.HASH256, 9)
# --- 256-bit (uncommon) --------------------------------------------------
sfBookDirectory = _f("BookDirectory", STI.HASH256, 16)
sfInvoiceID = _f("InvoiceID", STI.HASH256, 17)
sfNickname = _f("Nickname", STI.HASH256, 18)
sfAmendment = _f("Amendment", STI.HASH256, 19)

# --- 160-bit -------------------------------------------------------------
sfTakerPaysCurrency = _f("TakerPaysCurrency", STI.HASH160, 1)
sfTakerPaysIssuer = _f("TakerPaysIssuer", STI.HASH160, 2)
sfTakerGetsCurrency = _f("TakerGetsCurrency", STI.HASH160, 3)
sfTakerGetsIssuer = _f("TakerGetsIssuer", STI.HASH160, 4)

# --- amounts (common) ----------------------------------------------------
sfAmount = _f("Amount", STI.AMOUNT, 1)
sfBalance = _f("Balance", STI.AMOUNT, 2)
sfLimitAmount = _f("LimitAmount", STI.AMOUNT, 3)
sfTakerPays = _f("TakerPays", STI.AMOUNT, 4)
sfTakerGets = _f("TakerGets", STI.AMOUNT, 5)
sfLowLimit = _f("LowLimit", STI.AMOUNT, 6)
sfHighLimit = _f("HighLimit", STI.AMOUNT, 7)
sfFee = _f("Fee", STI.AMOUNT, 8)
sfSendMax = _f("SendMax", STI.AMOUNT, 9)
# --- amounts (uncommon) --------------------------------------------------
sfMinimumOffer = _f("MinimumOffer", STI.AMOUNT, 16)
sfRippleEscrow = _f("RippleEscrow", STI.AMOUNT, 17)
sfDeliveredAmount = _f("DeliveredAmount", STI.AMOUNT, 18)

# --- variable length -----------------------------------------------------
sfPublicKey = _f("PublicKey", STI.VL, 1)
sfMessageKey = _f("MessageKey", STI.VL, 2)
sfSigningPubKey = _f("SigningPubKey", STI.VL, 3)
sfTxnSignature = _f("TxnSignature", STI.VL, 4, signing=False)
sfGenerator = _f("Generator", STI.VL, 5)
sfSignature = _f("Signature", STI.VL, 6, signing=False)
sfDomain = _f("Domain", STI.VL, 7)
sfFundCode = _f("FundCode", STI.VL, 8)
sfRemoveCode = _f("RemoveCode", STI.VL, 9)
sfExpireCode = _f("ExpireCode", STI.VL, 10)
sfCreateCode = _f("CreateCode", STI.VL, 11)
sfMemoType = _f("MemoType", STI.VL, 12)
sfMemoData = _f("MemoData", STI.VL, 13)

# --- account -------------------------------------------------------------
sfAccount = _f("Account", STI.ACCOUNT, 1)
sfOwner = _f("Owner", STI.ACCOUNT, 2)
sfDestination = _f("Destination", STI.ACCOUNT, 3)
sfIssuer = _f("Issuer", STI.ACCOUNT, 4)
sfTarget = _f("Target", STI.ACCOUNT, 7)
sfRegularKey = _f("RegularKey", STI.ACCOUNT, 8)
sfInflationDest = _f("InflationDest", STI.ACCOUNT, 9)
sfSetAuthKey = _f("SetAuthKey", STI.ACCOUNT, 10)

# --- path set ------------------------------------------------------------
sfPaths = _f("Paths", STI.PATHSET, 1)

# --- vector256 -----------------------------------------------------------
sfIndexes = _f("Indexes", STI.VECTOR256, 1)
sfHashes = _f("Hashes", STI.VECTOR256, 2)
sfAmendments = _f("Amendments", STI.VECTOR256, 3)

# --- inner objects (OBJECT/1 reserved: end-of-object) --------------------
sfTransactionMetaData = _f("TransactionMetaData", STI.OBJECT, 2)
sfCreatedNode = _f("CreatedNode", STI.OBJECT, 3)
sfDeletedNode = _f("DeletedNode", STI.OBJECT, 4)
sfModifiedNode = _f("ModifiedNode", STI.OBJECT, 5)
sfPreviousFields = _f("PreviousFields", STI.OBJECT, 6)
sfFinalFields = _f("FinalFields", STI.OBJECT, 7)
sfNewFields = _f("NewFields", STI.OBJECT, 8)
sfTemplateEntry = _f("TemplateEntry", STI.OBJECT, 9)
sfMemo = _f("Memo", STI.OBJECT, 10)

# --- arrays (ARRAY/1 reserved: end-of-array) -----------------------------
sfSigningAccounts = _f("SigningAccounts", STI.ARRAY, 2)
sfTxnSignatures = _f("TxnSignatures", STI.ARRAY, 3)
sfSignatures = _f("Signatures", STI.ARRAY, 4)
sfTemplate = _f("Template", STI.ARRAY, 5)
sfNecessary = _f("Necessary", STI.ARRAY, 6)
sfSufficient = _f("Sufficient", STI.ARRAY, 7)
sfAffectedNodes = _f("AffectedNodes", STI.ARRAY, 8)
sfMemos = _f("Memos", STI.ARRAY, 9)

FIELDS: dict[str, SField] = dict(_REGISTRY_BY_NAME)


def field_by_code(type_id: int, value: int) -> SField | None:
    return _REGISTRY_BY_CODE.get((type_id << 16) | value)


def field_by_name(name: str) -> SField:
    return _REGISTRY_BY_NAME[name]


def sort_key(f: SField) -> tuple[int, int]:
    """Canonical serialization order (reference SField::compare)."""
    return (int(f.type_id), f.value)
