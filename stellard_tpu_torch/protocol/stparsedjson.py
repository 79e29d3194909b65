"""STParsedJSON: client JSON → STObject.

Reference: src/ripple_data/protocol/STParsedJSON.cpp — maps field names
to SFields and parses values according to the field's serialized type;
transaction types and TER tokens may appear as their symbolic names.
"""

from __future__ import annotations

from typing import Any

from .formats import TX_FORMATS_BY_NAME
from .sfields import STI, SField, field_by_name
from .stamount import STAmount
from .stobject import STArray, STObject, STPathSet, PathElement

__all__ = ["parse_tx_json", "parse_st_json"]


class JsonParseError(ValueError):
    pass


def _parse_value(f: SField, v: Any) -> Any:
    t = f.type_id
    if t in (STI.UINT8, STI.UINT16, STI.UINT32, STI.UINT64):
        if isinstance(v, str):
            # symbolic TransactionType ("Payment") per reference
            if f.name == "TransactionType":
                fmt = TX_FORMATS_BY_NAME.get(v)
                if fmt is None:
                    raise JsonParseError(f"unknown TransactionType {v!r}")
                return fmt.type_code
            return int(v, 0)
        if not isinstance(v, int):
            raise JsonParseError(f"{f.name}: expected integer")
        return v
    if t in (STI.HASH128, STI.HASH160, STI.HASH256):
        b = bytes.fromhex(v)
        want = {STI.HASH128: 16, STI.HASH160: 20, STI.HASH256: 32}[t]
        if len(b) != want:
            raise JsonParseError(f"{f.name}: expected {want} bytes")
        return b
    if t == STI.AMOUNT:
        return STAmount.from_json(v)
    if t == STI.VL:
        return bytes.fromhex(v)
    if t == STI.ACCOUNT:
        from .keys import decode_account_id

        if isinstance(v, str) and len(v) == 40:
            try:
                return bytes.fromhex(v)
            except ValueError:
                pass
        return decode_account_id(v)
    if t == STI.OBJECT:
        return parse_st_json(v)
    if t == STI.ARRAY:
        arr = STArray()
        for elem in v:
            if not isinstance(elem, dict) or len(elem) != 1:
                raise JsonParseError(f"{f.name}: array elements are single-key objects")
            (name, body), = elem.items()
            inner_f = field_by_name(name)
            if inner_f is None:
                raise JsonParseError(f"unknown field {name!r}")
            arr.append(inner_f, parse_st_json(body))
        return arr
    if t == STI.PATHSET:
        return _parse_pathset(v)
    if t == STI.VECTOR256:
        return [bytes.fromhex(h) for h in v]
    raise JsonParseError(f"{f.name}: unsupported type {t}")


def _parse_pathset(v: Any) -> STPathSet:
    from .keys import decode_account_id
    from .stamount import currency_from_iso

    paths = []
    for path in v:
        elems = []
        for e in path:
            account = issuer = None
            currency = None
            if e.get("account"):
                account = decode_account_id(e["account"])
            if e.get("issuer"):
                issuer = decode_account_id(e["issuer"])
            if e.get("currency") is not None:
                iso = e["currency"]
                currency = bytes.fromhex(iso) if len(iso) == 40 else currency_from_iso(iso)
            elems.append(PathElement(account=account, currency=currency, issuer=issuer))
        paths.append(elems)
    return STPathSet(paths)


def parse_st_json(j: dict) -> STObject:
    obj = STObject()
    for name, v in j.items():
        if name in ("hash", "metaData"):  # computed, never parsed in
            continue
        f = field_by_name(name)
        if f is None:
            raise JsonParseError(f"unknown field {name!r}")
        obj[f] = _parse_value(f, v)
    return obj


def parse_tx_json(j: dict) -> STObject:
    """Parse a client tx_json (reference: STParsedJSON via
    RPC::transactionSign)."""
    if "TransactionType" not in j:
        raise JsonParseError("missing TransactionType")
    return parse_st_json(j)
