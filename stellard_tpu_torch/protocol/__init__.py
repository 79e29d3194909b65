from .serializer import Serializer, BinaryParser, encode_vl_length
from .sfields import SField, STI, FIELDS, field_by_code, field_by_name
from .stamount import STAmount, currency_from_iso, iso_from_currency, CURRENCY_STR
from .stobject import STObject, STArray, STPathSet, PathElement
from .formats import (
    TX_FORMATS,
    TX_FORMATS_BY_NAME,
    LEDGER_FORMATS,
    LEDGER_FORMATS_BY_NAME,
    TxType,
    LedgerEntryType,
    SOE,
    validate_against,
)
from .ter import TER
from .keys import (
    KeyPair,
    verify_signature,
    signature_is_canonical,
    encode_account_id,
    decode_account_id,
    encode_seed,
    decode_seed,
    passphrase_to_seed,
)
