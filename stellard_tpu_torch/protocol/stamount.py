"""STAmount — the protocol's decimal amount type.

Two regimes, byte-compatible with the reference
(src/ripple_data/protocol/STAmount.cpp, SerializedTypes.h:450-458):

- **native** (STR, drops): 62-bit integer magnitude + sign; wire encoding is
  a single uint64 whose bit 62 marks "positive", bit 63 clear marks native.
- **issued** (IOU): decimal mantissa in [1e15, 1e16) with exponent in
  [-96, 80], plus 160-bit currency and issuer; wire encoding packs
  [1, sign, exponent+97] into the top 10 bits over a 54-bit mantissa,
  followed by currency and issuer (STAmount.cpp:470-489).

Arithmetic reproduces the reference's exact rounding:
multiply = (m1*m2)/10^14 + 7 (STAmount.cpp multiply), divide =
(num*10^17)/den + 5 (STAmount.cpp divide) — consensus splits on any
divergence, so these are bit-for-bit.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .serializer import Serializer, BinaryParser

CURRENCY_STR = b"\x00" * 20  # native currency id (all-zero uint160)
ACCOUNT_ZERO = b"\x00" * 20

MIN_VALUE = 10**15
MAX_VALUE = 10**16 - 1
MIN_OFFSET = -96
MAX_OFFSET = 80
MAX_NATIVE = 9_000_000_000_000_000_000
MAX_NATIVE_NETWORK = 100_000_000_000_000_000
NOT_NATIVE = 0x8000000000000000
POS_NATIVE = 0x4000000000000000

SYSTEM_CURRENCY_CODE = "STR"
SYSTEM_CURRENCY_PRECISION = 6
SYSTEM_CURRENCY_PARTS = 10**SYSTEM_CURRENCY_PRECISION


def currency_from_iso(iso: str) -> bytes:
    """3-letter ISO code -> 160-bit currency (ASCII at bytes 12..14,
    reference STAmount.cpp currencyFromString). Empty/'STR' -> zero."""
    if iso == "" or iso == SYSTEM_CURRENCY_CODE:
        return CURRENCY_STR
    if len(iso) != 3:
        raise ValueError(f"bad currency code {iso!r}")
    out = bytearray(20)
    out[12:15] = iso.upper().encode("ascii")
    return bytes(out)


def iso_from_currency(currency: bytes) -> str:
    if currency == CURRENCY_STR:
        return SYSTEM_CURRENCY_CODE
    body = currency[12:15]
    if currency[:12] == b"\x00" * 12 and currency[15:] == b"\x00" * 5:
        try:
            return body.decode("ascii")
        except UnicodeDecodeError:
            pass
    return currency.hex().upper()


_VALUE_RE = re.compile(r"^([-+]?)(\d*)(\.(\d*))?([eE]([+-]?)(\d+))?$")


@dataclass
class STAmount:
    """Value semantics; always canonicalized after construction."""

    currency: bytes = CURRENCY_STR
    issuer: bytes = ACCOUNT_ZERO
    mantissa: int = 0  # magnitude (drops when native)
    offset: int = 0
    negative: bool = False

    def __post_init__(self):
        self._canonicalize()

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_drops(cls, drops: int) -> "STAmount":
        return cls(CURRENCY_STR, ACCOUNT_ZERO, abs(drops), 0, drops < 0)

    @classmethod
    def zero_like(cls, currency: bytes, issuer: bytes) -> "STAmount":
        return cls(currency, issuer, 0, 0, False)

    @classmethod
    def from_iou(cls, currency: bytes, issuer: bytes, mantissa: int, offset: int,
                 negative: bool = False) -> "STAmount":
        return cls(currency, issuer, mantissa, offset, negative)

    @classmethod
    def from_json(cls, j) -> "STAmount":
        """Parse the client JSON forms: a string of drops for native, or
        {value, currency, issuer} for IOUs (reference STAmount.cpp:150-230)."""
        if isinstance(j, (int,)):
            return cls.from_drops(j)
        if isinstance(j, str):
            neg, mant, off = _parse_decimal(j)
            # bare string = native, expressed in drops; normalize the
            # exponent away (reference setValue walks offset back to 0)
            while off > 0:
                mant *= 10
                off -= 1
            while off < 0 and mant % 10 == 0:
                mant //= 10
                off += 1
            if off != 0:
                raise ValueError("native amount must be integral drops")
            return cls(CURRENCY_STR, ACCOUNT_ZERO, mant, 0, neg)
        if isinstance(j, dict):
            iso = j.get("currency", "")
            currency = (
                bytes.fromhex(iso) if len(iso) == 40 else currency_from_iso(iso)
            )
            issuer = ACCOUNT_ZERO
            if j.get("issuer"):
                from .keys import decode_account_id

                issuer = decode_account_id(j["issuer"])
            value = j.get("value", "0")
            if isinstance(value, (int, float)):
                value = repr(value)
            neg, mant, off = _parse_decimal(value)
            if currency == CURRENCY_STR:
                # native passed in object form: value is in STR units
                return cls(CURRENCY_STR, ACCOUNT_ZERO, mant, off + SYSTEM_CURRENCY_PRECISION, neg)
            return cls(currency, issuer, mant, off, neg)
        raise ValueError(f"cannot parse amount from {j!r}")

    # -- predicates -------------------------------------------------------

    @property
    def is_native(self) -> bool:
        return self.currency == CURRENCY_STR

    def is_zero(self) -> bool:
        return self.mantissa == 0

    def __bool__(self) -> bool:
        return self.mantissa != 0

    def signum(self) -> int:
        if self.mantissa == 0:
            return 0
        return -1 if self.negative else 1

    # -- canonical form (reference STAmount::canonicalize) ---------------

    def _canonicalize(self) -> None:
        if not isinstance(self.currency, bytes) or len(self.currency) != 20:
            raise ValueError("currency must be 20 bytes")
        if self.is_native:
            if self.mantissa == 0:
                self.offset = 0
                self.negative = False
                return
            while self.offset < 0:
                self.mantissa //= 10
                self.offset += 1
            while self.offset > 0:
                self.mantissa *= 10
                self.offset -= 1
            if self.mantissa > MAX_NATIVE:
                raise ValueError("native currency amount out of range")
            return
        if self.mantissa == 0:
            self.offset = -100
            self.negative = False
            return
        while self.mantissa < MIN_VALUE and self.offset > MIN_OFFSET:
            self.mantissa *= 10
            self.offset -= 1
        while self.mantissa > MAX_VALUE:
            if self.offset >= MAX_OFFSET:
                raise ValueError("IOU value overflow")
            self.mantissa //= 10
            self.offset += 1
        if self.offset < MIN_OFFSET or self.mantissa < MIN_VALUE:
            # underflow -> canonical zero
            self.mantissa = 0
            self.offset = -100
            self.negative = False

    # -- signed views -----------------------------------------------------

    def drops(self) -> int:
        """Signed native value (reference getSNValue)."""
        if not self.is_native:
            raise ValueError("not a native amount")
        return -self.mantissa if self.negative else self.mantissa

    # -- wire encoding (reference STAmount.cpp:470-489, :530-570) ---------

    def serialize(self, s: Serializer) -> None:
        if self.is_native:
            if self.negative:
                s.add64(self.mantissa)
            else:
                s.add64(self.mantissa | POS_NATIVE)
            return
        if self.mantissa == 0:
            s.add64(NOT_NATIVE)
        else:
            top = self.offset + 512 + 97 + (0 if self.negative else 256)
            s.add64(self.mantissa | (top << 54))
        s.add_bits(self.currency, 20)
        s.add_bits(self.issuer, 20)

    def wire_bytes(self) -> bytes:
        """Memoized wire encoding (8 bytes native / 48 bytes IOU) —
        amounts are value objects, never mutated after construction, so
        the first serialization's bytes serve every later one (the
        native serializer consumes this)."""
        w = getattr(self, "_wire", None)
        if w is None:
            s = Serializer()
            self.serialize(s)
            w = s.data()
            self._wire = w
        return w

    @classmethod
    def deserialize(cls, p: BinaryParser) -> "STAmount":
        value = p.read64()
        if (value & NOT_NATIVE) == 0:
            negative = (value & POS_NATIVE) == 0
            return cls.from_drops(-(value & ~POS_NATIVE) if negative else (value & ~POS_NATIVE))
        currency = p.read(20)
        issuer = p.read(20)
        if currency == CURRENCY_STR:
            raise ValueError("invalid native currency on IOU amount")
        mantissa = value & ((1 << 54) - 1)
        top = value >> 54
        if mantissa == 0:
            if value != NOT_NATIVE:
                raise ValueError("invalid IOU zero encoding")
            return cls.zero_like(currency, issuer)
        offset = (top & 0xFF) - 97
        negative = (top & 0x100) == 0
        if not (MIN_VALUE <= mantissa <= MAX_VALUE and MIN_OFFSET <= offset <= MAX_OFFSET):
            raise ValueError("invalid IOU amount encoding")
        return cls(currency, issuer, mantissa, offset, negative)

    # -- arithmetic (exact reference rounding) ----------------------------

    def __neg__(self) -> "STAmount":
        if self.mantissa == 0:
            return self
        return STAmount(self.currency, self.issuer, self.mantissa, self.offset, not self.negative)

    def _signed(self) -> tuple[int, int]:
        m = -self.mantissa if self.negative else self.mantissa
        return m, self.offset

    def __add__(self, other: "STAmount") -> "STAmount":
        _check_comparable(self, other)
        if self.is_native:
            return STAmount.from_drops(self.drops() + other.drops())
        if other.mantissa == 0:
            return STAmount(self.currency, self.issuer, self.mantissa, self.offset, self.negative)
        if self.mantissa == 0:
            return STAmount(self.currency, self.issuer, other.mantissa, other.offset, other.negative)
        # align to common offset (reference operator+: offsets walked to match)
        m1, o1 = self._signed()
        m2, o2 = other._signed()
        while o1 < o2:
            m1 = _div10_toward_zero(m1)
            o1 += 1
        while o2 < o1:
            m2 = _div10_toward_zero(m2)
            o2 += 1
        total = m1 + m2
        # tiny cancelling sums collapse to zero (reference operator+,
        # STAmount.cpp: |sum| <= 10 -> canonical zero)
        if -10 <= total <= 10:
            return STAmount.zero_like(self.currency, self.issuer)
        return STAmount(self.currency, self.issuer, abs(total), o1, total < 0)

    def __sub__(self, other: "STAmount") -> "STAmount":
        return self + (-other)

    def compare(self, other: "STAmount") -> int:
        _check_comparable(self, other)
        s1, s2 = self.signum(), other.signum()
        if s1 != s2:
            return -1 if s1 < s2 else 1
        if s1 == 0:
            return 0
        mag = self._compare_magnitude(other)
        return mag * (-1 if self.negative else 1)

    def _compare_magnitude(self, other: "STAmount") -> int:
        if self.is_native:
            a, b = self.mantissa, other.mantissa
        else:
            if self.offset != other.offset:
                return -1 if self.offset < other.offset else 1
            a, b = self.mantissa, other.mantissa
        if a == b:
            return 0
        return -1 if a < b else 1

    def __eq__(self, other) -> bool:
        if not isinstance(other, STAmount):
            return NotImplemented
        return (
            self.currency == other.currency
            and self.issuer == other.issuer
            and self.mantissa == other.mantissa
            and self.offset == other.offset
            and self.negative == other.negative
        )

    def __lt__(self, other: "STAmount") -> bool:
        return self.compare(other) < 0

    def __le__(self, other: "STAmount") -> bool:
        return self.compare(other) <= 0

    def __gt__(self, other: "STAmount") -> bool:
        return self.compare(other) > 0

    def __ge__(self, other: "STAmount") -> bool:
        return self.compare(other) >= 0

    def __hash__(self):
        return hash((self.currency, self.issuer, self.mantissa, self.offset, self.negative))

    @staticmethod
    def multiply(v1: "STAmount", v2: "STAmount", currency: bytes, issuer: bytes) -> "STAmount":
        """Reference STAmount::multiply — (m1*m2)/10^14 + 7 rounding."""
        if v1.is_zero() or v2.is_zero():
            return STAmount.zero_like(currency, issuer)
        if v1.is_native and v2.is_native and currency == CURRENCY_STR:
            prod = abs(v1.drops()) * abs(v2.drops())
            if prod > MAX_NATIVE:
                raise ValueError("native value overflow")
            return STAmount.from_drops(prod if v1.negative == v2.negative else -prod)
        m1, o1 = _to_iou_range(v1.mantissa, v1.offset, v1.is_native)
        m2, o2 = _to_iou_range(v2.mantissa, v2.offset, v2.is_native)
        mant = (m1 * m2) // 10**14 + 7
        return STAmount(currency, issuer, mant, o1 + o2 + 14, v1.negative != v2.negative)

    @staticmethod
    def divide(num: "STAmount", den: "STAmount", currency: bytes, issuer: bytes) -> "STAmount":
        """Reference STAmount::divide — (num*10^17)/den + 5 rounding."""
        if den.is_zero():
            raise ZeroDivisionError("amount division by zero")
        if num.is_zero():
            return STAmount.zero_like(currency, issuer)
        m1, o1 = _to_iou_range(num.mantissa, num.offset, num.is_native)
        m2, o2 = _to_iou_range(den.mantissa, den.offset, den.is_native)
        mant = (m1 * 10**17) // m2 + 5
        return STAmount(currency, issuer, mant, o1 - o2 - 17, num.negative != den.negative)

    # -- text / JSON ------------------------------------------------------

    def value_text(self) -> str:
        """Decimal rendering of the magnitude with sign (reference getText)."""
        if self.is_native:
            return str(self.drops())
        if self.mantissa == 0:
            return "0"
        sign = "-" if self.negative else ""
        m, e = self.mantissa, self.offset
        while m % 10 == 0 and m:
            m //= 10
            e += 1
        digits = str(m)
        if e >= 0:
            return sign + digits + "0" * e
        if -e < len(digits):
            ip, fp = digits[:e], digits[e:]
            return f"{sign}{ip}.{fp}"
        return sign + "0." + "0" * (-e - len(digits)) + digits

    def to_json(self):
        if self.is_native:
            return str(self.drops())
        from .keys import encode_account_id

        return {
            "value": self.value_text(),
            "currency": iso_from_currency(self.currency),
            "issuer": encode_account_id(self.issuer),
        }

    def __repr__(self):
        if self.is_native:
            return f"STAmount({self.drops()} drops)"
        return f"STAmount({self.value_text()} {iso_from_currency(self.currency)})"


def _check_comparable(a: STAmount, b: STAmount) -> None:
    if a.is_native != b.is_native:
        raise ValueError("amount comparison across native/IOU")
    if not a.is_native and a.currency != b.currency:
        raise ValueError("amount comparison across currencies")


def _div10_toward_zero(v: int) -> int:
    return -((-v) // 10) if v < 0 else v // 10


def _to_iou_range(mantissa: int, offset: int, is_native: bool) -> tuple[int, int]:
    """Bring a native magnitude into IOU mantissa range (reference
    multiply/divide preamble loops)."""
    if is_native:
        while mantissa < MIN_VALUE:
            mantissa *= 10
            offset -= 1
    return mantissa, offset


def _parse_decimal(text: str) -> tuple[bool, int, int]:
    """Parse sign/mantissa/exponent from a decimal string
    (reference STAmount::setValue regex, STAmount.cpp:276-330)."""
    m = _VALUE_RE.match(text.strip())
    if not m or (not m.group(2) and not m.group(4)):
        raise ValueError(f"cannot parse amount {text!r}")
    negative = m.group(1) == "-"
    int_part = m.group(2) or ""
    frac_part = m.group(4) or ""
    exp = int(m.group(7) or 0) * (-1 if m.group(6) == "-" else 1)
    mantissa = int(int_part + frac_part or "0")
    offset = exp - len(frac_part)
    if mantissa == 0:
        return False, 0, 0
    return negative, mantissa, offset
