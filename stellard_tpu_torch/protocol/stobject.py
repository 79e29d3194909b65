"""STObject — self-describing typed object serialization.

The canonical container of the protocol: a mapping of SField -> typed value
that serializes to sorted, tagged binary (reference:
src/ripple_data/protocol/SerializedObject.cpp, SerializedTypes.cpp).

Python value representation per serialized type:
  UINT8/16/32/64    int
  HASH128/160/256   bytes (fixed width)
  AMOUNT            STAmount
  VL                bytes
  ACCOUNT           bytes (20-byte account ID; wire form is VL-encoded)
  OBJECT            STObject
  ARRAY             STArray
  PATHSET           STPathSet
  VECTOR256         list[bytes]
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as _dcfield
from typing import Any, Iterator

from ..utils.hashes import prefix_hash
from .serializer import BinaryParser, Serializer
from .sfields import (
    K_ACCOUNT,
    K_AMOUNT,
    K_ARRAY,
    K_HASH,
    K_OBJECT,
    K_PATHSET,
    K_UINT8,
    K_UINT64,
    K_VECTOR256,
    K_VL,
    STI,
    SField,
    _REGISTRY_BY_CODE as _FIELD_BY_CODE,
    field_by_code,
    sort_key,
)
from .stamount import STAmount

_OBJECT_END = (int(STI.OBJECT), 1)  # 0xE1 marker
_OBJECT_END_CODE = (int(STI.OBJECT) << 16) | 1
_ARRAY_END = (int(STI.ARRAY), 1)  # 0xF1 marker

# Path-element type bits (reference SerializedTypes.h STPathElement)
PATH_ACCOUNT = 0x01
PATH_CURRENCY = 0x10
PATH_ISSUER = 0x20


@dataclass(frozen=True)
class PathElement:
    account: bytes | None = None
    currency: bytes | None = None
    issuer: bytes | None = None

    @property
    def kind(self) -> int:
        k = 0
        if self.account is not None:
            k |= PATH_ACCOUNT
        if self.currency is not None:
            k |= PATH_CURRENCY
        if self.issuer is not None:
            k |= PATH_ISSUER
        return k


@dataclass
class STPathSet:
    paths: list[list[PathElement]] = _dcfield(default_factory=list)

    def serialize(self, s: Serializer) -> None:
        for i, path in enumerate(self.paths):
            if i:
                s.add8(0xFF)  # path boundary
            for el in path:
                s.add8(el.kind)
                if el.account is not None:
                    s.add_bits(el.account, 20)
                if el.currency is not None:
                    s.add_bits(el.currency, 20)
                if el.issuer is not None:
                    s.add_bits(el.issuer, 20)
        s.add8(0x00)  # end of path set

    @classmethod
    def deserialize(cls, p: BinaryParser) -> "STPathSet":
        paths: list[list[PathElement]] = [[]]
        while True:
            kind = p.read8()
            if kind == 0x00:
                break
            if kind == 0xFF:
                paths.append([])
                continue
            account = p.read(20) if kind & PATH_ACCOUNT else None
            currency = p.read(20) if kind & PATH_CURRENCY else None
            issuer = p.read(20) if kind & PATH_ISSUER else None
            paths[-1].append(PathElement(account, currency, issuer))
        if paths == [[]]:
            paths = []
        return cls(paths)

    def __len__(self) -> int:
        return len(self.paths)

    def to_json(self):
        from .keys import encode_account_id
        from .stamount import iso_from_currency

        out = []
        for path in self.paths:
            jp = []
            for el in path:
                je: dict[str, Any] = {"type": el.kind, "type_hex": f"{el.kind:016X}"}
                if el.account is not None:
                    je["account"] = encode_account_id(el.account)
                if el.currency is not None:
                    je["currency"] = iso_from_currency(el.currency)
                if el.issuer is not None:
                    je["issuer"] = encode_account_id(el.issuer)
                jp.append(je)
            out.append(jp)
        return out


# single-byte end markers: OBJECT(14)<<4|1, ARRAY(15)<<4|1
_OBJECT_END_B = b"\xe1"
_ARRAY_END_B = b"\xf1"


def _serialize_value(s: Serializer, f: SField, v: Any) -> None:
    """Encode one field value (header already written). Dispatch is over
    the precomputed SField.kind int — enum identity tests and per-call
    field-id encoding were measurable at flood rates."""
    k = f.kind
    buf = s._buf
    if 0 <= k <= K_UINT64:  # the four uint kinds, widths precomputed
        if k == K_UINT8:
            buf.append(v & 0xFF)
        else:
            # masked like Serializer.add16/32/64 (silent truncation is
            # the historical add* contract)
            buf += (v & ((1 << (8 * f.width)) - 1)).to_bytes(f.width, "big")
    elif k == K_HASH:
        if len(v) != f.width:
            raise ValueError(f"expected {f.width} bytes, got {len(v)}")
        buf += v
    elif k == K_AMOUNT:
        v.serialize(s)
    elif k == K_VL:
        s.add_vl(v)
    elif k == K_ACCOUNT:
        if len(v) != 20:
            raise ValueError("account field must be 20 bytes")
        buf.append(20)
        buf += v
    elif k == K_OBJECT:
        v.serialize_to(s)
        buf += _OBJECT_END_B
    elif k == K_ARRAY:
        v.serialize_to(s)
        buf += _ARRAY_END_B
    elif k == K_PATHSET:
        v.serialize(s)
    elif k == K_VECTOR256:
        s.add_vl(b"".join(v))
    else:
        raise ValueError(f"cannot serialize field type {f.type_id}")


def _deserialize_value(p: BinaryParser, f: SField) -> Any:
    k = f.kind
    if 0 <= k <= K_UINT64:
        return int.from_bytes(p.read(f.width), "big")
    if k == K_HASH:
        return p.read(f.width)
    if k == K_AMOUNT:
        return STAmount.deserialize(p)
    if k == K_VL:
        return p.read_vl()
    if k == K_ACCOUNT:
        v = p.read_vl()
        if len(v) != 20:
            raise ValueError("account field must be 20 bytes")
        return v
    if k == K_OBJECT:
        return STObject.deserialize(p, inner=True)
    if k == K_ARRAY:
        return STArray.deserialize(p)
    if k == K_PATHSET:
        return STPathSet.deserialize(p)
    if k == K_VECTOR256:
        raw = p.read_vl()
        if len(raw) % 32:
            raise ValueError("bad vector256 length")
        return [raw[i : i + 32] for i in range(0, len(raw), 32)]
    raise ValueError(f"cannot deserialize field type {f.type_id}")


# -- native fast path ------------------------------------------------------
# The _stser CPython extension (native/src/stser.cc, this package's own
# build: native.load_stser) encodes the sorted pair list in C and parses
# wire bytes into STObjects; container kinds call back into
# _container_chunk, which recurses through the same machinery per nesting
# level. STELLARD_NATIVE_STSER=0 keeps the Python loops below, which
# give the same bytes and objects.

_STSER = None
_STSER_TRIED = False


def _container_chunk(f: SField, v: Any) -> bytes:
    s = Serializer()
    _serialize_value(s, f, v)
    return s.data()


def _obj_from_parse(fields: dict, in_order: bool) -> "STObject":
    """Native-parser factory: wrap a C-built fields dict; canonical wire
    order seeds the sort memo exactly like the Python loop."""
    obj = STObject()
    obj._fields = fields
    if in_order:
        obj._sorted_keys = (0, list(fields))
    return obj


def _arr_from_parse(items: list) -> "STArray":
    return STArray(items)


def _amount_from_wire(b: bytes) -> "STAmount":
    # the full validation lives in STAmount.deserialize: the C parser
    # only slices the 8- or 48-byte region
    return STAmount.deserialize(BinaryParser(b))


def _pathset_from_wire(b: bytes) -> "STPathSet":
    return STPathSet.deserialize(BinaryParser(b))


def _get_stser():
    """The registered native codec, or None (switched off, or no
    compiler). Resolved once a process; ``_reset_stser`` resolves it
    again (the switch read anew)."""
    global _STSER, _STSER_TRIED
    if not _STSER_TRIED:
        _STSER_TRIED = True
        if os.environ.get("STELLARD_NATIVE_STSER", "1") != "0":
            try:
                from ..native import load_stser
                from .sfields import all_fields

                mod = load_stser()
                if mod is not None:
                    mod.register_fields(
                        [(f.cid, f.header, f.kind, f.width, 1 if f.signing else 0)
                         for f in all_fields() if f.kind >= 0],
                        _container_chunk,
                    )
                    mod.register_parse(
                        [(f.code, f, f.kind, f.width)
                         for f in all_fields() if f.kind >= 0],
                        _obj_from_parse,
                        _arr_from_parse,
                        _amount_from_wire,
                        _pathset_from_wire,
                    )
                    _STSER = mod
            except Exception:  # noqa: BLE001 — the Python loops
                _STSER = None
    return _STSER


def _reset_stser() -> None:
    global _STSER, _STSER_TRIED
    _STSER, _STSER_TRIED = None, False


def _copy_value(v: Any) -> Any:
    if isinstance(v, list):
        return [_copy_value(x) for x in v]
    if isinstance(v, STObject):
        return v.copy()
    if isinstance(v, STArray):
        return STArray([(f, o.copy()) for f, o in v])
    return v  # scalars / bytes / STAmount are value-like


class STObject:
    """Ordered-by-canon field map."""

    __slots__ = ("_fields", "_version", "_sorted_keys", "_pairs")

    def __init__(self, fields: dict[SField, Any] | None = None):
        self._fields: dict[SField, Any] = dict(fields or {})
        # bumped on every mutation so holders (SerializedTransaction)
        # can memoize serializations/hashes safely — the reference
        # recomputes getTransactionID per call and its own comment says
        # "perhaps we should cache this" (SerializedTransaction.cpp:169)
        self._version = 0
        # (version, [keys in canonical order]) — every serialization
        # sorts the field set; ledger entries are serialized many times
        # between mutations
        self._sorted_keys: tuple[int, list[SField]] | None = None
        # (version, [(field, value)...]) — fields() is called several
        # times per apply (serialize, meta, invariants); rebuild only
        # after mutation
        self._pairs: tuple[int, list[tuple[SField, Any]]] | None = None

    # -- mapping interface -------------------------------------------------

    def __contains__(self, f: SField) -> bool:
        return f in self._fields

    def __getitem__(self, f: SField) -> Any:
        return self._fields[f]

    def __setitem__(self, f: SField, v: Any) -> None:
        self._fields[f] = v
        self._version += 1

    def __delitem__(self, f: SField) -> None:
        del self._fields[f]
        self._version += 1

    def get(self, f: SField, default: Any = None) -> Any:
        return self._fields.get(f, default)

    def pop(self, f: SField, default: Any = None) -> Any:
        self._version += 1
        return self._fields.pop(f, default)

    def fields(self) -> Iterator[tuple[SField, Any]]:
        return iter(self._pairs_list())

    def _pairs_list(self) -> list[tuple[SField, Any]]:
        """Canonically sorted (field, value) pairs, memoized per version.
        Callers must NOT mutate the list (fields() hands out
        iterators)."""
        pairs = self._pairs
        if pairs is not None and pairs[0] == self._version:
            return pairs[1]
        memo = self._sorted_keys
        if memo is None or memo[0] != self._version:
            keys = sorted(self._fields, key=sort_key)
            self._sorted_keys = memo = (self._version, keys)
        fields = self._fields
        # materialized so callers keep snapshot semantics under mutation
        lst = [(k, fields[k]) for k in memo[1]]
        self._pairs = (self._version, lst)
        return lst

    def copy(self) -> "STObject":
        """Copy that detaches container values (lists, nested objects,
        arrays) so mutating the copy never aliases the original."""
        out = STObject()
        out._fields = {f: _copy_value(v) for f, v in self._fields.items()}
        memo = self._sorted_keys
        if memo is not None and memo[0] == self._version:
            # the key list is never mutated in place (fields() replaces
            # the tuple wholesale), so sharing it across copies is safe
            out._sorted_keys = (0, memo[1])
        return out

    def __len__(self) -> int:
        return len(self._fields)

    def __eq__(self, other):
        return isinstance(other, STObject) and self._fields == other._fields

    def __repr__(self):
        inner = ", ".join(f"{f!r}={v!r}" for f, v in self.fields())
        return f"STObject({inner})"

    # -- serialization -----------------------------------------------------

    def serialize_to(self, s: Serializer, *, signing: bool = False) -> None:
        """Canonical serialization: fields sorted by (type, value); when
        ``signing``, non-signing fields (signatures) are omitted
        (reference STObject::getSerializer / getSigningHash,
        SerializedObject.cpp:444)."""
        st = _get_stser()
        if st is not None:
            s._buf += st.serialize(self._pairs_list(), 1 if signing else 0)
            return
        buf = s._buf
        for f, v in self.fields():
            if signing and not f.signing:
                continue
            buf += f.header
            _serialize_value(s, f, v)

    def serialize(self, *, signing: bool = False) -> bytes:
        s = Serializer()
        self.serialize_to(s, signing=signing)
        return s.data()

    def signing_hash(self, prefix: int) -> bytes:
        return prefix_hash(prefix, self.serialize(signing=True))

    def hash(self, prefix: int) -> bytes:
        return prefix_hash(prefix, self.serialize())

    @classmethod
    def deserialize(cls, p: BinaryParser, *, inner: bool = False) -> "STObject":
        st = _get_stser()
        if st is not None and cls is STObject:
            # the native parser builds base STObjects; a subclass takes
            # the Python loop
            obj, pos = st.parse(p._data, p._pos, 1 if inner else 0)
            p._pos = pos
            return obj
        obj = cls()
        fields = obj._fields
        data = p._data
        end = len(data)
        # canonical input (the overwhelmingly common case: our own
        # serializer always writes sorted) seeds the sort memo so the
        # next serialization skips the sort; non-canonical wire input
        # falls back to sorting in fields(). A field's code
        # (type << 16 | name) orders as its sort_key does.
        in_order = True
        prev_code = -1
        while p._pos < end:
            # a one-byte header (type and name both 1-15) and the
            # fixed-width and 20-byte account values are read in place;
            # the rest, and every short read, through the parser
            b1 = data[p._pos]
            if b1 & 0x0F and b1 & 0xF0:
                p._pos += 1
                code = ((b1 >> 4) << 16) | (b1 & 0x0F)
            else:
                type_id, name = p.read_field_id()
                code = (type_id << 16) | name
            if inner and code == _OBJECT_END_CODE:
                if in_order:
                    obj._sorted_keys = (obj._version, list(fields))
                return obj
            f = _FIELD_BY_CODE.get(code)
            if f is None:
                raise ValueError(f"unknown field ({code >> 16}, {code & 0xFFFF})")
            if in_order:
                if code < prev_code:
                    in_order = False
                prev_code = code
            k = f.kind
            pos = p._pos
            if 0 <= k <= K_UINT64:
                nxt = pos + f.width
                if nxt <= end:
                    fields[f] = int.from_bytes(data[pos:nxt], "big")
                    p._pos = nxt
                    continue
            elif k == K_HASH:
                nxt = pos + f.width
                if nxt <= end:
                    fields[f] = data[pos:nxt]
                    p._pos = nxt
                    continue
            elif k == K_ACCOUNT and pos + 21 <= end and data[pos] == 20:
                fields[f] = data[pos + 1 : pos + 21]
                p._pos = pos + 21
                continue
            fields[f] = _deserialize_value(p, f)
        if inner:
            raise ValueError("unterminated inner object")
        if in_order:
            obj._sorted_keys = (obj._version, list(fields))
        return obj

    @classmethod
    def from_bytes(cls, data: bytes) -> "STObject":
        return cls.deserialize(BinaryParser(data))

    # -- JSON --------------------------------------------------------------

    def to_json(self) -> dict:
        from .keys import encode_account_id

        out: dict[str, Any] = {}
        for f, v in self.fields():
            k = f.kind
            if 0 <= k <= K_UINT64:
                # render the type discriminators symbolically, as the
                # reference's STObject::getJson does via KnownFormats
                if f.name == "TransactionType":
                    from .formats import TX_FORMATS, TxType

                    try:
                        fmt = TX_FORMATS.get(TxType(v))
                        out[f.name] = fmt.name if fmt else v
                    except ValueError:
                        out[f.name] = v
                else:
                    out[f.name] = v
            elif k == K_HASH:
                out[f.name] = v.hex().upper()
            elif k == K_AMOUNT:
                out[f.name] = v.to_json()
            elif k == K_VL:
                out[f.name] = v.hex().upper()
            elif k == K_ACCOUNT:
                out[f.name] = encode_account_id(v)
            elif k == K_OBJECT:
                out[f.name] = v.to_json()
            elif k == K_ARRAY:
                out[f.name] = v.to_json()
            elif k == K_PATHSET:
                out[f.name] = v.to_json()
            elif k == K_VECTOR256:
                out[f.name] = [h.hex().upper() for h in v]
        return out


class STArray:
    """Array of named inner objects."""

    __slots__ = ("items",)

    def __init__(self, items: list[tuple[SField, STObject]] | None = None):
        self.items: list[tuple[SField, STObject]] = list(items or [])

    def append(self, f: SField, obj: STObject) -> None:
        self.items.append((f, obj))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __eq__(self, other):
        return isinstance(other, STArray) and self.items == other.items

    def serialize_to(self, s: Serializer) -> None:
        st = _get_stser()
        if st is not None:
            # the items ride the same native loop: K_OBJECT goes through
            # the container callback (header, body, end marker)
            s._buf += st.serialize(self.items, 0)
            return
        for f, obj in self.items:
            s._buf += f.header
            obj.serialize_to(s)
            s._buf += _OBJECT_END_B

    @classmethod
    def deserialize(cls, p: BinaryParser) -> "STArray":
        arr = cls()
        while True:
            type_id, name = p.read_field_id()
            if (type_id, name) == _ARRAY_END:
                return arr
            f = field_by_code(type_id, name)
            if f is None or f.type_id != STI.OBJECT:
                raise ValueError(f"bad array element field ({type_id}, {name})")
            arr.items.append((f, STObject.deserialize(p, inner=True)))

    def to_json(self):
        return [{f.name: obj.to_json()} for f, obj in self.items]
