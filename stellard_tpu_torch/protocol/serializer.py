"""Canonical binary serialization.

Byte-compatible with the reference Serializer
(src/ripple_data/protocol/Serializer.cpp): big-endian integers,
variable-length blobs with the 1/2/3-byte length prefix (Serializer.cpp
addEncoded/encodeLengthLength), field headers packed by (type, name)
commonness (Serializer.cpp:193-223, addFieldID).
"""

from __future__ import annotations

from ..utils.hashes import prefix_hash, sha512_half

_VL1_MAX = 192
_VL2_MAX = 12480
_VL3_MAX = 918744


def encode_vl_length(length: int) -> bytes:
    if length <= _VL1_MAX:
        return bytes([length])
    if length <= _VL2_MAX:
        length -= _VL1_MAX + 1
        return bytes([193 + (length >> 8), length & 0xFF])
    if length <= _VL3_MAX:
        length -= _VL2_MAX + 1
        return bytes([241 + (length >> 16), (length >> 8) & 0xFF, length & 0xFF])
    raise ValueError(f"VL length {length} too long")


class Serializer:
    """Append-only canonical byte builder."""

    __slots__ = ("_buf",)

    def __init__(self, data: bytes = b""):
        self._buf = bytearray(data)

    def __len__(self) -> int:
        return len(self._buf)

    def data(self) -> bytes:
        return bytes(self._buf)

    def add8(self, v: int) -> None:
        self._buf.append(v & 0xFF)

    def add16(self, v: int) -> None:
        self._buf += (v & 0xFFFF).to_bytes(2, "big")

    def add32(self, v: int) -> None:
        self._buf += (v & 0xFFFFFFFF).to_bytes(4, "big")

    def add64(self, v: int) -> None:
        self._buf += (v & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big")

    def add_raw(self, data: bytes) -> None:
        self._buf += data

    def add_bits(self, data: bytes, nbytes: int) -> None:
        """Fixed-width big-endian byte string (uint128/160/256)."""
        if len(data) != nbytes:
            raise ValueError(f"expected {nbytes} bytes, got {len(data)}")
        self._buf += data

    def add_vl(self, data: bytes) -> None:
        self._buf += encode_vl_length(len(data))
        self._buf += data

    def add_field_id(self, type_id: int, name: int) -> None:
        # single source of truth for the field-id encoding: the same
        # function that precomputes SField.header (sfields._field_header)
        from .sfields import _field_header

        self._buf += _field_header(type_id, name)

    def sha512_half(self) -> bytes:
        return sha512_half(bytes(self._buf))

    def prefix_hash(self, prefix: int) -> bytes:
        return prefix_hash(prefix, bytes(self._buf))


class BinaryParser:
    """Sequential reader over canonical bytes."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def empty(self) -> bool:
        return self._pos >= len(self._data)

    def remaining(self) -> int:
        return len(self._data) - self._pos

    def read(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise ValueError("parser underflow")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def read8(self) -> int:
        return self.read(1)[0]

    def read16(self) -> int:
        return int.from_bytes(self.read(2), "big")

    def read32(self) -> int:
        return int.from_bytes(self.read(4), "big")

    def read64(self) -> int:
        return int.from_bytes(self.read(8), "big")

    def read_vl(self) -> bytes:
        b1 = self.read8()
        if b1 <= _VL1_MAX:
            length = b1
        elif b1 <= 240:
            b2 = self.read8()
            length = _VL1_MAX + 1 + ((b1 - 193) << 8) + b2
        elif b1 <= 254:
            b2, b3 = self.read8(), self.read8()
            length = _VL2_MAX + 1 + ((b1 - 241) << 16) + (b2 << 8) + b3
        else:
            raise ValueError("invalid VL length byte")
        return self.read(length)

    def read_field_id(self) -> tuple[int, int]:
        b1 = self.read8()
        type_id = b1 >> 4
        name = b1 & 0x0F
        if type_id == 0:
            type_id = self.read8()
            if type_id == 0 or type_id < 16:
                raise ValueError("invalid field id encoding")
            if name == 0:
                name = self.read8()
                if name == 0 or name < 16:
                    raise ValueError("invalid field id encoding")
        elif name == 0:
            name = self.read8()
            if name == 0 or name < 16:
                raise ValueError("invalid field id encoding")
        return type_id, name
