"""Shared-memory ring transport for the Block-STM worker pool.

The JAX package's ``engine/specring.py``, carried over byte for byte on
the wire: the same object encodes to the same bytes in both packages,
and each decodes the other's. Over pickled ``multiprocessing.Pipe``s
every chunk paid a pickle, a syscall per send, and a pickle again on the
far side; this module replaces that wire with single-producer/
single-consumer byte rings over ``multiprocessing.shared_memory``:

- one ring per direction per worker, data moves by memcpy into the
  mapped segment — no per-message allocation on the wire, no pickle;
- messages are encoded with a small fixed-vocabulary tagged binary codec
  (``encode_msg``/``decode_msg``) covering exactly the types the spec
  protocol ships (ints, bytes, str, float, None, bool, tuples/lists/
  dicts/sets) — a pickle-free reply can never execute code on the
  parent, and a torn slot can never half-deserialize into a live object;
- every record carries a fixed-layout slot header
  ``[magic u32][len u32][crc32 u32][seq u32]`` so a torn or corrupted
  slot is DETECTED (``TornSlotError``) instead of misparsed — the
  committer treats it exactly like a worker death;
- readiness is an ``os.pipe`` doorbell with a strict one-byte-per-record
  protocol: the producer publishes the record (payload, then head
  pointer) BEFORE writing the doorbell byte, so a consumer that read a
  byte is guaranteed to pop a whole record; the doorbell fd is what
  ``fileno()`` exposes, so ``multiprocessing.connection.wait`` keeps
  multiplexing worker channels exactly as it did with pipes, and peer
  death surfaces as EOF on the doorbell just like a broken pipe did.

``RingConn`` mimics the ``Connection`` API (``send``/``recv``/``poll``/
``fileno``/``close``) so ``_worker_main``, ``_Proc`` and the committer
loop run unchanged over either transport ([spec] transport=ring|pipe).
A record larger than the ring (4 MiB by default) raises ``OSError`` at
``send``; nothing enlarges the ring on its own.

This module imports neither ``torch`` nor anything that does: the pool's
forked workers must never reach the card.
"""

from __future__ import annotations

import os
import select
import struct
import threading
import time
import zlib
from multiprocessing import shared_memory

__all__ = [
    "RingConn",
    "TornSlotError",
    "ring_pipe",
    "encode_msg",
    "decode_msg",
]


class TornSlotError(OSError):
    """A ring slot failed validation (magic/len/crc/seq): the peer died
    mid-write or the segment was corrupted. Raised from ``recv`` so the
    committer's existing (EOFError, OSError) death handling absorbs it."""


# ---------------------------------------------------------------------------
# codec — the spec wire vocabulary, no pickle
# ---------------------------------------------------------------------------
#
# Tags (1 byte each):
#   N None   T True   F False
#   I int    (u8 length + signed big-endian bytes)
#   D float  (8-byte IEEE double)
#   B bytes  (u32 length + raw)
#   S str    (u32 length + utf-8)
#   U tuple  L list   M dict   Y set   Z frozenset  (u32 count + items)

_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")


def _encode(obj, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out += b"N"
    elif t is bool:
        out += b"T" if obj else b"F"
    elif t is int:
        b = obj.to_bytes((obj.bit_length() + 8) // 8, "big", signed=True)
        if len(b) > 255:
            raise ValueError("int too large for spec wire")
        out += b"I"
        out.append(len(b))
        out += b
    elif t is float:
        out += b"D"
        out += _F64.pack(obj)
    elif t is bytes:
        out += b"B"
        out += _U32.pack(len(obj))
        out += obj
    elif t is str:
        e = obj.encode("utf-8")
        out += b"S"
        out += _U32.pack(len(e))
        out += e
    elif t is tuple:
        out += b"U"
        out += _U32.pack(len(obj))
        for item in obj:
            _encode(item, out)
    elif t is list:
        out += b"L"
        out += _U32.pack(len(obj))
        for item in obj:
            _encode(item, out)
    elif t is dict:
        out += b"M"
        out += _U32.pack(len(obj))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif t is set:
        out += b"Y"
        out += _U32.pack(len(obj))
        for item in obj:
            _encode(item, out)
    elif t is frozenset:
        out += b"Z"
        out += _U32.pack(len(obj))
        for item in obj:
            _encode(item, out)
    elif t is bytearray or t is memoryview:
        b = bytes(obj)
        out += b"B"
        out += _U32.pack(len(b))
        out += b
    else:
        raise TypeError(f"type {t.__name__} is not in the spec wire "
                        f"vocabulary")


def _decode(buf, pos: int):
    tag = buf[pos:pos + 1]
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"I":
        n = buf[pos]
        pos += 1
        return int.from_bytes(buf[pos:pos + n], "big", signed=True), pos + n
    if tag == b"D":
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag == b"B":
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        return bytes(buf[pos:pos + n]), pos + n
    if tag == b"S":
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if tag in (b"U", b"L", b"Y", b"Z"):
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _decode(buf, pos)
            items.append(item)
        if tag == b"U":
            return tuple(items), pos
        if tag == b"L":
            return items, pos
        if tag == b"Y":
            return set(items), pos
        return frozenset(items), pos
    if tag == b"M":
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _decode(buf, pos)
            v, pos = _decode(buf, pos)
            d[k] = v
        return d, pos
    raise TornSlotError(f"unknown wire tag {tag!r}")


def encode_msg(obj) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def decode_msg(payload) -> object:
    try:
        obj, pos = _decode(payload, 0)
    except TornSlotError:
        raise
    except (struct.error, IndexError, ValueError, OverflowError) as exc:
        # truncated/garbled bytes must surface as a TORN slot (the
        # committer's worker-death path), never as a stray struct.error
        # that would crash the committer thread
        raise TornSlotError(f"undecodable ring record: {exc}") from None
    if pos != len(payload):
        raise TornSlotError(
            f"trailing garbage in ring record ({len(payload) - pos} bytes)"
        )
    return obj


# ---------------------------------------------------------------------------
# the SPSC byte ring
# ---------------------------------------------------------------------------

_MAGIC = 0x52494E47  # "RING"
_HDR = struct.Struct("<IIII")  # magic, len, crc32, seq
_HEAD_OFF = 0    # u64, monotonic, producer-written
_TAIL_OFF = 8    # u64, monotonic, consumer-written
_DATA_OFF = 64   # keep the pointers on their own cache line
_Q = struct.Struct("<Q")


class _Ring:
    """Single-producer/single-consumer byte ring in a shared segment.
    head/tail are monotonic u64 byte counters; records are a 16-byte slot
    header + payload, padded to 8 bytes, copied with a wrap split (no
    alignment constraint on the reader side beyond the header struct)."""

    def __init__(self, shm: shared_memory.SharedMemory, capacity: int):
        self.shm = shm
        self.cap = capacity
        self.buf = shm.buf
        self.seq_out = 0  # producer-side record sequence
        self.seq_in = 0   # consumer-side expected sequence

    # -- pointer access (8-byte pack/unpack; the doorbell read/write
    #    syscalls on either side of every access are full barriers, so
    #    the values a woken peer reads are published and stable) --------

    def _head(self) -> int:
        return _Q.unpack_from(self.buf, _HEAD_OFF)[0]

    def _tail(self) -> int:
        return _Q.unpack_from(self.buf, _TAIL_OFF)[0]

    def _copy_in(self, pos: int, data) -> None:
        off = pos % self.cap
        first = min(len(data), self.cap - off)
        self.buf[_DATA_OFF + off:_DATA_OFF + off + first] = data[:first]
        if first < len(data):
            self.buf[_DATA_OFF:_DATA_OFF + len(data) - first] = data[first:]

    def _copy_out(self, pos: int, n: int) -> bytes:
        off = pos % self.cap
        first = min(n, self.cap - off)
        out = bytes(self.buf[_DATA_OFF + off:_DATA_OFF + off + first])
        if first < n:
            out += bytes(self.buf[_DATA_OFF:_DATA_OFF + n - first])
        return out

    def push(self, payload: bytes, timeout: float = 5.0) -> int:
        """Append one record. Returns the number of bounded full-ring
        waits taken; raises OSError when the ring never drains (a wedged
        or dead consumer — the caller's worker-death path handles it)."""
        need = _HDR.size + ((len(payload) + 7) & ~7)
        if need > self.cap:
            raise OSError(
                f"ring record ({need}B) exceeds ring capacity ({self.cap}B)"
            )
        head = self._head()
        waits = 0
        deadline = None
        while self.cap - (head - self._tail()) < need:
            waits += 1
            if deadline is None:
                deadline = time.monotonic() + timeout
            elif time.monotonic() > deadline:
                raise OSError("ring full: consumer is not draining")
            time.sleep(0.0002)
        rec = _HDR.pack(_MAGIC, len(payload), zlib.crc32(payload),
                        self.seq_out & 0xFFFFFFFF)
        self._copy_in(head, rec)
        self._copy_in(head + _HDR.size, payload)
        self.seq_out += 1
        # publish LAST: a consumer woken by the doorbell (written by the
        # caller after this returns) always sees a whole record
        _Q.pack_into(self.buf, _HEAD_OFF, head + need)
        return waits

    def pop(self):
        """Remove and return the next record's payload, or None when the
        ring is empty. Validates the slot header; a failed check raises
        TornSlotError and leaves the ring poisoned (no further pops)."""
        tail = self._tail()
        head = self._head()
        if head == tail:
            return None
        if head - tail < _HDR.size:
            raise TornSlotError("ring header truncated")
        magic, length, crc, seq = _HDR.unpack(
            self._copy_out(tail, _HDR.size))
        need = _HDR.size + ((length + 7) & ~7)
        if magic != _MAGIC or head - tail < need or length > self.cap:
            raise TornSlotError(
                f"torn ring slot: magic={magic:#x} len={length} "
                f"avail={head - tail}"
            )
        if seq != self.seq_in & 0xFFFFFFFF:
            raise TornSlotError(
                f"ring slot out of sequence: got {seq}, "
                f"want {self.seq_in & 0xFFFFFFFF}"
            )
        payload = self._copy_out(tail + _HDR.size, length)
        if zlib.crc32(payload) != crc:
            raise TornSlotError("ring slot crc mismatch")
        self.seq_in += 1
        _Q.pack_into(self.buf, _TAIL_OFF, tail + need)
        return payload


# ---------------------------------------------------------------------------
# the Connection-shaped channel
# ---------------------------------------------------------------------------


class RingConn:
    """One end of a simplex shared-memory ring channel.

    ``role`` is "send" or "recv". Both ends share ONE SharedMemory
    mapping (created pre-fork; the child inherits it — on this Python,
    attaching by name would re-register the segment with the resource
    tracker and get it unlinked out from under the peer). Each end owns
    ONE doorbell fd (read for "recv", write for "send") and records the
    peer's fd number so post-fork ``settle`` can drop the inherited copy
    — that is what turns peer death into EOF/EPIPE, exactly like the
    pipe transport. ``destroy`` (creator process only) releases and
    unlinks the segment."""

    def __init__(self, ring: _Ring, own_fd: int, peer_fd: int, role: str,
                 owner_pid: int):
        self._ring = ring
        self._fd = own_fd
        self._peer_fd = peer_fd
        self.role = role
        self._owner_pid = owner_pid
        self._closed = False
        self.counters = {"msgs": 0, "bytes": 0, "full_waits": 0,
                         "torn_slots": 0}
        self.torn_error: str | None = None  # the last torn slot's reason

    # -- Connection API ----------------------------------------------------

    def send(self, obj) -> None:
        if self._closed:
            raise OSError("ring channel closed")
        payload = encode_msg(obj)
        self.counters["full_waits"] += self._ring.push(payload)
        self.counters["msgs"] += 1
        self.counters["bytes"] += len(payload)
        os.write(self._fd, b"\x01")  # doorbell: strictly 1 byte/record

    def recv(self):
        if self._closed:
            raise EOFError("ring channel closed")
        b = os.read(self._fd, 1)
        if b == b"":
            raise EOFError("ring peer closed")
        try:
            payload = self._ring.pop()
            if payload is None:
                # the doorbell byte promises a published record
                raise TornSlotError("doorbell rang on an empty ring")
            msg = decode_msg(payload)
        except TornSlotError as exc:
            self.counters["torn_slots"] += 1
            self.torn_error = str(exc)
            raise
        self.counters["msgs"] += 1
        self.counters["bytes"] += len(payload)
        return msg

    def poll(self, timeout: float = 0.0) -> bool:
        r, _w, _x = select.select([self._fd], [], [], timeout)
        return bool(r)

    def fileno(self) -> int:
        # the doorbell read fd: multiprocessing.connection.wait
        # readiness is exact (one byte pending <=> one record poppable)
        return self._fd

    # -- lifecycle ---------------------------------------------------------

    def settle(self) -> None:
        """Post-fork fd hygiene, called once per KEPT end in each
        process: drop this process's copy of the peer's doorbell fd so
        peer death surfaces as EOF (reader side) / EPIPE (writer side)
        exactly like a broken pipe did."""
        fd, self._peer_fd = self._peer_fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass

    def close(self) -> None:
        """Close this end's fds (idempotent). Never touches the shared
        segment — a forked child must not tear the mapping out from
        under the parent; ``destroy`` does that, in the creator only."""
        if self._closed:
            return
        self._closed = True
        for fd in (self._fd, self._peer_fd):
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._fd = self._peer_fd = -1

    def destroy(self) -> None:
        """close() plus segment release+unlink — creator process only
        (the executor's stop path calls this on the ends it kept)."""
        self.close()
        if os.getpid() != self._owner_pid:
            return
        try:
            self._ring.buf = None
            self._ring.shm.close()
        except (OSError, BufferError):
            pass
        try:
            self._ring.shm.unlink()
        except OSError:
            pass


def ring_pipe(capacity: int = 1 << 22) -> tuple[RingConn, RingConn]:
    """-> (recv_end, send_end), mirroring ``ctx.Pipe(duplex=False)``.
    Build BEFORE fork; pass the child its end through Process args (the
    fork start method does not pickle them)."""
    shm = shared_memory.SharedMemory(create=True,
                                     size=_DATA_OFF + capacity)
    shm.buf[:_DATA_OFF] = b"\x00" * _DATA_OFF
    rfd, wfd = os.pipe()
    ring = _Ring(shm, capacity)
    pid = os.getpid()
    return (RingConn(ring, rfd, wfd, "recv", pid),
            RingConn(ring, wfd, rfd, "send", pid))
