"""Minimal protobuf (proto2) wire-format codec, written from scratch.

The reference's overlay speaks protobuf messages defined in
src/ripple/proto/ripple.proto, framed by Message.cpp's 6-byte header.
SURVEY §5 names "same protobuf schema" as the wire-compatibility target,
so overlay.wire encodes its messages in genuine protobuf wire format
with ripple.proto's field numbers — via this ~150-line codec rather than
a vendored protobuf build (the reference vendors all of protobuf 2.x,
108k LoC, for exactly the subset implemented here: varint, 32/64-bit
and length-delimited fields, repeated fields, nested messages).

Encoding is a list of (field_number, wire_value) appends; decoding
parses a buffer into {field_number: [values]} with ints for varint /
fixed fields and bytes for length-delimited ones. Unknown fields are
skipped, which is what makes protobuf schemas forward-compatible.
"""

from __future__ import annotations

__all__ = [
    "Encoder",
    "parse",
    "first",
    "first_bytes",
    "first_int",
]

# wire types
WT_VARINT = 0
WT_FIXED64 = 1
WT_LEN = 2
WT_FIXED32 = 5


def _varint(n: int) -> bytes:
    if n < 0:
        # proto2 int32/int64 negatives encode as 10-byte two's complement
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class Encoder:
    """Append-only protobuf message encoder."""

    def __init__(self):
        self._parts: list[bytes] = []

    def _tag(self, field: int, wt: int) -> None:
        self._parts.append(_varint((field << 3) | wt))

    def varint(self, field: int, value: int) -> "Encoder":
        self._tag(field, WT_VARINT)
        self._parts.append(_varint(int(value)))
        return self

    def boolean(self, field: int, value: bool) -> "Encoder":
        return self.varint(field, 1 if value else 0)

    def blob(self, field: int, value: bytes) -> "Encoder":
        self._tag(field, WT_LEN)
        self._parts.append(_varint(len(value)))
        self._parts.append(bytes(value))
        return self

    def string(self, field: int, value: str) -> "Encoder":
        return self.blob(field, value.encode("utf-8"))

    def message(self, field: int, sub: "Encoder") -> "Encoder":
        return self.blob(field, sub.data())

    def fixed32(self, field: int, value: int) -> "Encoder":
        self._tag(field, WT_FIXED32)
        self._parts.append(int(value).to_bytes(4, "little"))
        return self

    def fixed64(self, field: int, value: int) -> "Encoder":
        self._tag(field, WT_FIXED64)
        self._parts.append(int(value).to_bytes(8, "little"))
        return self

    def data(self) -> bytes:
        return b"".join(self._parts)


def parse(buf: bytes) -> dict[int, list]:
    """Parse a protobuf message into {field: [values]} (ints / bytes).
    Raises ValueError on truncation or a malformed tag."""
    out: dict[int, list] = {}
    i = 0
    n = len(buf)
    while i < n:
        # tag varint
        tag = 0
        shift = 0
        while True:
            if i >= n:
                raise ValueError("truncated tag")
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                break
            if shift > 63:
                raise ValueError("tag varint overflow")
        field, wt = tag >> 3, tag & 7
        if field == 0:
            raise ValueError("field number 0")
        if wt == WT_VARINT:
            val = 0
            shift = 0
            while True:
                if i >= n:
                    raise ValueError("truncated varint")
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not (b & 0x80):
                    break
                if shift > 70:
                    raise ValueError("varint overflow")
        elif wt == WT_FIXED64:
            if i + 8 > n:
                raise ValueError("truncated fixed64")
            val = int.from_bytes(buf[i : i + 8], "little")
            i += 8
        elif wt == WT_LEN:
            ln = 0
            shift = 0
            while True:
                if i >= n:
                    raise ValueError("truncated length")
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not (b & 0x80):
                    break
                if shift > 35:
                    raise ValueError("length overflow")
            if i + ln > n:
                raise ValueError("truncated length-delimited field")
            val = bytes(buf[i : i + ln])
            i += ln
        elif wt == WT_FIXED32:
            if i + 4 > n:
                raise ValueError("truncated fixed32")
            val = int.from_bytes(buf[i : i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(field, []).append(val)
    return out


def first(fields: dict[int, list], field: int, default=None):
    vals = fields.get(field)
    return vals[0] if vals else default


def first_bytes(fields: dict[int, list], field: int, default: bytes = b"") -> bytes:
    v = first(fields, field, default)
    if not isinstance(v, (bytes, bytearray)):
        raise ValueError(f"field {field}: expected bytes")
    return bytes(v)


def first_int(fields: dict[int, list], field: int, default: int = 0) -> int:
    v = first(fields, field, default)
    if not isinstance(v, int):
        raise ValueError(f"field {field}: expected int")
    return v
