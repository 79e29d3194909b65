"""Wire schema for peer-to-peer messages — protobuf-compatible.

Reference: src/ripple/proto/ripple.proto (TM* messages) framed by the
6-byte header of ripple_overlay/impl/Message.cpp:

    4 bytes big-endian payload length | 2 bytes big-endian message type

Payloads are genuine protobuf (proto2) wire format with ripple.proto's
message-type numbers and field numbers — SURVEY §5's "same protobuf
schema" compatibility target — encoded by overlay.proto (a from-scratch
~150-line codec standing in for the reference's vendored 108k-LoC
protobuf build). The Python-facing message classes below keep their
framework-internal shape; only their byte encoding follows ripple.proto:

    Hello          <-> TMHello            (mt 1)
    Ping           <-> TMPing             (mt 3)
    ClusterStatus  <-> TMCluster          (mt 5)
    Endpoints      <-> TMEndpoints        (mt 15)
    TxMessage      <-> TMTransaction      (mt 30)
    GetLedger      <-> TMGetLedger        (mt 31)
    GetTxSet       <-> TMGetLedger        (mt 31, itype liTS_CANDIDATE —
                                           the reference acquires candidate
                                           tx sets through TMGetLedger)
    LedgerData     <-> TMLedgerData       (mt 32)
    TxSetData      <-> TMLedgerData       (mt 32, liTS_CANDIDATE)
    ProposeSet     <-> TMProposeSet       (mt 33)
    StatusChange   <-> TMStatusChange     (mt 34)
    HaveTxSet      <-> TMHaveTransactionSet (mt 35)
    ValidationMessage <-> TMValidation    (mt 41)
    GetObjects     <-> TMGetObjectByHash  (mt 42, query=true)
    ObjectsData    <-> TMGetObjectByHash  (mt 42, query=false)

Two EXTENSION messages (mt 54/55, outside ripple.proto — both ends of a
stellard-tpu private net speak them; a reference peer would reject them
as out-of-schema, which is why the segment catch-up plane only engages
against peers that answered a manifest request):

    GetSegments    (mt 54)  segment-granular catch-up: manifest request
                            (seg_id < 0) or one chunk of one segment
    SegmentData    (mt 55)  manifest reply or a verified-by-content
                            chunk of a store segment (nodestore/segstore
                            ``fetch_segment`` read door)

One EXTENSION FIELD (outside ripple.proto, Dapper-style): TxMessage,
ProposeSet, ValidationMessage, GetSegments and SegmentData may carry a
nested ``TraceContext`` submessage at field 60 (trace id + parent span
token + flags) so spans on different nodes join one causal tree. proto2
parsers skip unknown fields, so a reference peer ignores it; when
``[trace] propagate=0`` the field is never emitted and every frame is
byte-identical to the legacy wire.
"""

from __future__ import annotations

import socket as _socket
from dataclasses import dataclass, field
from enum import IntEnum

from ..consensus.proposal import LedgerProposal
from .proto import Encoder, first, first_bytes, first_int, parse

__all__ = [
    "MessageType",
    "TraceContext",
    "TRACE_CTX_FIELD",
    "Hello",
    "Ping",
    "TxMessage",
    "ProposeSet",
    "ValidationMessage",
    "HaveTxSet",
    "GetTxSet",
    "TxSetData",
    "GetLedger",
    "LedgerData",
    "StatusChange",
    "Endpoints",
    "ClusterStatus",
    "ClusterUpdate",
    "GetObjects",
    "ObjectsData",
    "GetSegments",
    "SegmentData",
    "SEGMENT_CHUNK",
    "encode_message",
    "decode_message",
    "frame",
    "FrameReader",
]

HEADER_LEN = 6
MAX_FRAME = 64 * 1024 * 1024

# ripple.proto TMLedgerInfoType
LI_BASE = 0
LI_TX_NODE = 1
LI_AS_NODE = 2
LI_TS_CANDIDATE = 3

# ripple.proto TransactionStatus / TxSetStatus
TS_CURRENT = 2
TXSET_HAVE = 1


# field number of the TraceContext extension submessage — high enough to
# clear every ripple.proto field on the five messages that carry it
TRACE_CTX_FIELD = 60


@dataclass
class TraceContext:
    """Cross-node trace propagation extension (Dapper-style): the trace
    id (raw 32-byte txid or a utf-8 trace string), the sender's span id
    as the receiver's parent token, and a flags varint (bit0 = sampled).
    Stamped ONCE at the origin and never restamped on relay, so every
    relayed copy of a frame stays byte-identical (content-hash dedup)."""

    trace: bytes = b""
    parent: int = 0
    sampled: bool = True


def _enc_trace_ctx(e: Encoder, ctx: "TraceContext | None") -> None:
    if ctx is None:
        return
    sub = Encoder().blob(1, ctx.trace).varint(2, ctx.parent)
    sub.varint(3, 1 if ctx.sampled else 0)
    e.message(TRACE_CTX_FIELD, sub)


def _dec_trace_ctx(f: dict) -> "TraceContext | None":
    raw = first(f, TRACE_CTX_FIELD)
    if not isinstance(raw, (bytes, bytearray)):
        return None
    try:
        cf = parse(bytes(raw))
        return TraceContext(
            trace=first_bytes(cf, 1),
            parent=first_int(cf, 2),
            sampled=bool(first_int(cf, 3)),
        )
    except ValueError:
        return None  # malformed extension never drops the message


class MessageType(IntEnum):
    """ripple.proto MessageType numbers (the wire ids)."""

    HELLO = 1
    PING = 3
    CLUSTER = 5
    ENDPOINTS = 15
    TRANSACTION = 30
    GET_LEDGER = 31
    LEDGER_DATA = 32
    PROPOSE_SET = 33
    STATUS_CHANGE = 34
    HAVE_TX_SET = 35
    VALIDATION = 41
    GET_OBJECTS = 42
    # stellard-tpu extensions (outside ripple.proto)
    GET_SEGMENTS = 54
    SEGMENT_DATA = 55


@dataclass
class Hello:
    """Session handshake: protocol version, our node key, a signature of
    the session's shared fingerprint proving key ownership, our chain
    tip, and the port our own listener accepts on — inbound sessions
    arrive from an ephemeral port, so discovery (PeerFinder) needs the
    listen port advertised explicitly (reference: TMHello ipv4Port)."""

    proto_version: int
    net_time: int
    node_public: bytes
    session_sig: bytes
    ledger_seq: int
    closed_ledger: bytes
    listen_port: int = 0


@dataclass
class Ping:
    is_pong: bool
    seq: int


@dataclass
class TxMessage:
    blob: bytes  # serialized STTx
    trace_ctx: "TraceContext | None" = None


@dataclass
class ProposeSet:
    propose_seq: int
    close_time: int
    prev_ledger: bytes
    tx_set_hash: bytes
    node_public: bytes
    signature: bytes
    trace_ctx: "TraceContext | None" = None

    @classmethod
    def from_proposal(cls, p: LedgerProposal) -> "ProposeSet":
        return cls(
            p.propose_seq,
            p.close_time,
            p.prev_ledger,
            p.tx_set_hash,
            p.node_public,
            p.signature,
        )

    def to_proposal(self) -> LedgerProposal:
        return LedgerProposal(
            self.prev_ledger,
            self.propose_seq,
            self.tx_set_hash,
            self.close_time,
            self.node_public,
            self.signature,
        )


@dataclass
class ValidationMessage:
    blob: bytes  # serialized STValidation
    trace_ctx: "TraceContext | None" = None


@dataclass
class HaveTxSet:
    set_hash: bytes


@dataclass
class GetTxSet:
    set_hash: bytes


@dataclass
class TxSetData:
    set_hash: bytes
    tx_blobs: list = field(default_factory=list)


@dataclass
class GetLedger:
    ledger_hash: bytes
    ledger_seq: int  # 0 = by hash
    what: int  # 0=base header, 1=tx tree, 2=state tree (liBASE/TX/AS)
    node_ids: list = field(default_factory=list)  # wire node-id blobs


@dataclass
class LedgerData:
    ledger_hash: bytes
    ledger_seq: int
    what: int
    nodes: list = field(default_factory=list)  # (node_id, node_blob)


@dataclass
class StatusChange:
    status: int  # OperatingMode value
    ledger_seq: int
    ledger_hash: bytes
    network_time: int


@dataclass
class Endpoints:
    endpoints: list = field(default_factory=list)  # (host, port, hops)


@dataclass
class ClusterStatus:
    """Same-operator load report (reference: mtCLUSTER /
    ClusterNodeStatus.h): cluster members share their load fee so every
    member escalates together."""

    node_public: bytes
    load_fee: int
    report_time: int


@dataclass
class ClusterUpdate:
    """Decoded TMCluster: every clusterNodes entry (the field is
    `repeated` — a member reports all cluster nodes it knows)."""

    nodes: list = field(default_factory=list)  # [ClusterStatus, ...]


# one SegmentData chunk's payload budget: large enough that a few round
# trips move a whole segment, small enough that one request's timeout
# clock covers a bounded transfer
SEGMENT_CHUNK = 1 << 20


@dataclass
class GetSegments:
    """Segment-granular catch-up request: ``seg_id < 0`` asks for the
    peer's segment manifest; otherwise one chunk of segment ``seg_id``
    starting at ``offset``."""

    seg_id: int = -1
    offset: int = 0
    # snapshot handoff (doc/follower.md): the epoch the fetcher is
    # pinned to — 0 = don't-care (manifest requests, pre-epoch peers).
    # proto2 unknown-field skip keeps old peers wire-compatible.
    snap_epoch: int = 0
    trace_ctx: "TraceContext | None" = None


@dataclass
class SegmentData:
    """Manifest reply (``seg_id < 0``, ``segments`` rows) or one chunk of
    one segment: ``total`` is the full segment size so the fetcher knows
    when it holds the whole byte range."""

    seg_id: int = -1
    total: int = 0
    offset: int = 0
    data: bytes = b""
    # manifest rows: (id, size, live, active[, lo, hi, file_bytes]).
    # lo/hi advertise a sealed shard's ledger-seq range and file_bytes
    # its full on-disk size (the SHARD_FILE door serves whole files);
    # all three ride nonzero-only so legacy rows stay byte-identical.
    segments: list = field(default_factory=list)
    # snapshot handoff: the serving peer's sealed-set epoch + validated
    # seq at reply time (0 = a pre-epoch peer; fetchers treat as
    # don't-care). An epoch that MOVES mid-transfer means the source
    # rotated/compacted under the fetcher → restart from the manifest.
    snap_epoch: int = 0
    snap_seq: int = 0
    trace_ctx: "TraceContext | None" = None


@dataclass
class GetObjects:
    hashes: list = field(default_factory=list)


@dataclass
class ObjectsData:
    objects: list = field(default_factory=list)  # (hash, blob)


# -- encoding: dataclass -> ripple.proto wire shape ------------------------


def _enc_hello(m: Hello) -> bytes:
    e = Encoder()
    e.varint(1, m.proto_version)  # protoVersion
    e.varint(2, m.proto_version)  # protoVersionMin
    e.blob(3, m.node_public)  # nodePublic
    e.blob(4, m.session_sig)  # nodeProof
    e.varint(6, m.net_time)  # netTime
    e.varint(7, m.listen_port)  # ipv4Port
    e.varint(8, m.ledger_seq)  # ledgerIndex
    e.blob(9, m.closed_ledger)  # ledgerClosed
    return e.data()


def _dec_hello(buf: bytes) -> Hello:
    f = parse(buf)
    return Hello(
        proto_version=first_int(f, 1),
        net_time=first_int(f, 6),
        node_public=first_bytes(f, 3),
        session_sig=first_bytes(f, 4),
        ledger_seq=first_int(f, 8),
        closed_ledger=first_bytes(f, 9, b"\x00" * 32),
        listen_port=first_int(f, 7),
    )


def _enc_ping(m: Ping) -> bytes:
    return Encoder().varint(1, 1 if m.is_pong else 0).varint(2, m.seq).data()


def _dec_ping(buf: bytes) -> Ping:
    f = parse(buf)
    return Ping(first_int(f, 1) == 1, first_int(f, 2))


def _enc_tx(m: TxMessage) -> bytes:
    e = Encoder().blob(1, m.blob).varint(2, TS_CURRENT)
    _enc_trace_ctx(e, m.trace_ctx)
    return e.data()


def _dec_tx(buf: bytes) -> TxMessage:
    f = parse(buf)
    return TxMessage(first_bytes(f, 1), trace_ctx=_dec_trace_ctx(f))


def _enc_propose(m: ProposeSet) -> bytes:
    e = Encoder()
    e.varint(1, m.propose_seq)  # proposeSeq
    e.blob(2, m.tx_set_hash)  # currentTxHash
    e.blob(3, m.node_public)  # nodePubKey
    e.varint(4, m.close_time)  # closeTime
    e.blob(5, m.signature)  # signature
    e.blob(6, m.prev_ledger)  # previousledger
    _enc_trace_ctx(e, m.trace_ctx)
    return e.data()


def _dec_propose(buf: bytes) -> ProposeSet:
    f = parse(buf)
    return ProposeSet(
        propose_seq=first_int(f, 1),
        close_time=first_int(f, 4),
        prev_ledger=first_bytes(f, 6, b"\x00" * 32),
        tx_set_hash=first_bytes(f, 2),
        node_public=first_bytes(f, 3),
        signature=first_bytes(f, 5),
        trace_ctx=_dec_trace_ctx(f),
    )


def _enc_validation(m: ValidationMessage) -> bytes:
    e = Encoder().blob(1, m.blob)
    _enc_trace_ctx(e, m.trace_ctx)
    return e.data()


def _dec_validation(buf: bytes) -> ValidationMessage:
    f = parse(buf)
    return ValidationMessage(first_bytes(f, 1), trace_ctx=_dec_trace_ctx(f))


def _enc_have_set(m: HaveTxSet) -> bytes:
    return Encoder().varint(1, TXSET_HAVE).blob(2, m.set_hash).data()


def _dec_have_set(buf: bytes) -> HaveTxSet:
    return HaveTxSet(first_bytes(parse(buf), 2))


def _enc_get_set(m: GetTxSet) -> bytes:
    # reference: candidate tx sets acquire via TMGetLedger liTS_CANDIDATE
    return Encoder().varint(1, LI_TS_CANDIDATE).blob(3, m.set_hash).data()


def _enc_get_ledger(m: GetLedger) -> bytes:
    e = Encoder()
    e.varint(1, m.what)  # itype: liBASE/liTX_NODE/liAS_NODE
    e.blob(3, m.ledger_hash)  # ledgerHash
    if m.ledger_seq:
        e.varint(4, m.ledger_seq)  # ledgerSeq
    for nid in m.node_ids:
        e.blob(5, nid)  # nodeIDs
    return e.data()


def _dec_get_ledger(buf: bytes):
    f = parse(buf)
    itype = first_int(f, 1)
    if itype == LI_TS_CANDIDATE:
        return GetTxSet(first_bytes(f, 3))
    return GetLedger(
        ledger_hash=first_bytes(f, 3),
        ledger_seq=first_int(f, 4),
        what=itype,
        node_ids=[bytes(v) for v in f.get(5, [])],
    )


def _ledger_node(nodedata: bytes, nodeid: bytes | None = None) -> Encoder:
    sub = Encoder().blob(1, nodedata)
    if nodeid is not None:
        sub.blob(2, nodeid)
    return sub


def _enc_set_data(m: TxSetData) -> bytes:
    e = Encoder()
    e.blob(1, m.set_hash)  # ledgerHash (the tx-set hash here)
    e.varint(2, 0)  # ledgerSeq (none for a candidate set)
    e.varint(3, LI_TS_CANDIDATE)  # type
    for blob in m.tx_blobs:
        e.message(4, _ledger_node(blob))  # nodes: nodedata only
    return e.data()


def _enc_ledger_data(m: LedgerData) -> bytes:
    e = Encoder()
    e.blob(1, m.ledger_hash)
    e.varint(2, m.ledger_seq)
    e.varint(3, m.what)
    for nid, blob in m.nodes:
        e.message(4, _ledger_node(blob, nid))
    return e.data()


def _dec_ledger_data(buf: bytes):
    f = parse(buf)
    itype = first_int(f, 3)
    nodes = [parse(sub) for sub in f.get(4, [])]
    if itype == LI_TS_CANDIDATE:
        return TxSetData(
            first_bytes(f, 1), [first_bytes(nf, 1) for nf in nodes]
        )
    return LedgerData(
        ledger_hash=first_bytes(f, 1),
        ledger_seq=first_int(f, 2),
        what=itype,
        nodes=[(first_bytes(nf, 2), first_bytes(nf, 1)) for nf in nodes],
    )


def _enc_status(m: StatusChange) -> bytes:
    e = Encoder()
    # NodeStatus is 1-based (nsCONNECTING=1..); OperatingMode is 0-based
    e.varint(1, m.status + 1)  # newStatus
    e.varint(3, m.ledger_seq)  # ledgerSeq
    e.blob(4, m.ledger_hash)  # ledgerHash
    e.varint(6, m.network_time)  # networkTime
    return e.data()


def _dec_status(buf: bytes) -> StatusChange:
    f = parse(buf)
    return StatusChange(
        status=max(first_int(f, 1) - 1, 0),
        ledger_seq=first_int(f, 3),
        ledger_hash=first_bytes(f, 4, b"\x00" * 32),
        network_time=first_int(f, 6),
    )


def _cluster_node(m: ClusterStatus) -> Encoder:
    from ..protocol.keys import encode_node_public

    node = Encoder()
    node.string(1, encode_node_public(m.node_public))  # publicKey (base58)
    node.varint(2, m.report_time)  # reportTime
    node.varint(3, m.load_fee)  # nodeLoad
    return node


def _enc_cluster(m: ClusterStatus) -> bytes:
    return Encoder().message(1, _cluster_node(m)).data()


def _enc_cluster_update(m: "ClusterUpdate") -> bytes:
    e = Encoder()
    for node in m.nodes:
        e.message(1, _cluster_node(node))
    return e.data()


def _dec_cluster(buf: bytes) -> "ClusterUpdate":
    """TMCluster.clusterNodes is `repeated`: a member may report every
    cluster node it knows (or none — loadSources only). All entries
    decode; malformed public keys skip their entry, never the message."""
    from ..protocol.keys import decode_node_public

    f = parse(buf)
    nodes = []
    for sub in f.get(1, []):
        nf = parse(sub)
        try:
            pub = decode_node_public(first_bytes(nf, 1).decode("utf-8"))
        except Exception:  # noqa: BLE001 — skip one bad entry, keep the rest
            continue
        nodes.append(
            ClusterStatus(
                node_public=pub,
                load_fee=first_int(nf, 3),
                report_time=first_int(nf, 2),
            )
        )
    return ClusterUpdate(nodes)


def _enc_endpoints(m: Endpoints) -> bytes:
    e = Encoder()
    e.varint(1, 1)  # version
    for host, port, hops in m.endpoints:
        try:
            ipv4 = int.from_bytes(_socket.inet_aton(host), "big")
        except OSError:
            continue  # TMIPv4Endpoint cannot carry non-IPv4 hosts
        ip = Encoder().varint(1, ipv4).varint(2, port)
        ep = Encoder().message(1, ip).varint(2, hops)
        e.message(2, ep)
    return e.data()


def _dec_endpoints(buf: bytes) -> Endpoints:
    f = parse(buf)
    out = []
    for sub in f.get(2, []):
        ef = parse(sub)
        ipf = parse(first_bytes(ef, 1))
        host = _socket.inet_ntoa(first_int(ipf, 1).to_bytes(4, "big"))
        out.append((host, first_int(ipf, 2), first_int(ef, 2)))
    return Endpoints(out)


def _enc_get_segments(m: GetSegments) -> bytes:
    # seg_id rides +1 so the manifest sentinel (-1) stays a valid varint
    e = Encoder().varint(1, m.seg_id + 1).varint(2, m.offset)
    if m.snap_epoch:
        e.varint(3, m.snap_epoch)
    _enc_trace_ctx(e, m.trace_ctx)
    return e.data()


def _dec_get_segments(buf: bytes) -> GetSegments:
    f = parse(buf)
    return GetSegments(
        seg_id=first_int(f, 1) - 1,
        offset=first_int(f, 2),
        snap_epoch=first_int(f, 3),
        trace_ctx=_dec_trace_ctx(f),
    )


def _enc_segment_data(m: SegmentData) -> bytes:
    e = Encoder()
    e.varint(1, m.seg_id + 1)
    e.varint(2, m.total)
    e.varint(3, m.offset)
    if m.data:
        e.blob(4, m.data)
    for seg in m.segments:
        sid, size, live, active = seg[0], seg[1], seg[2], seg[3]
        row = (
            Encoder().varint(1, sid + 1).varint(2, size)
            .varint(3, live).varint(4, 1 if active else 0)
        )
        # sealed-shard range advertisement (nonzero-only: a legacy
        # 4-tuple row and a zero-extended 7-tuple encode identically)
        lo = seg[4] if len(seg) > 4 else 0
        hi = seg[5] if len(seg) > 5 else 0
        fbytes = seg[6] if len(seg) > 6 else 0
        if lo:
            row.varint(5, lo)
        if hi:
            row.varint(6, hi)
        if fbytes:
            row.varint(7, fbytes)
        e.message(5, row)
    if m.snap_epoch:
        e.varint(6, m.snap_epoch)
    if m.snap_seq:
        e.varint(7, m.snap_seq)
    _enc_trace_ctx(e, m.trace_ctx)
    return e.data()


def _dec_segment_data(buf: bytes) -> SegmentData:
    f = parse(buf)
    segments = []
    for sub in f.get(5, []):
        rf = parse(sub)
        segments.append((
            first_int(rf, 1) - 1,
            first_int(rf, 2),
            first_int(rf, 3),
            bool(first_int(rf, 4)),
            first_int(rf, 5),
            first_int(rf, 6),
            first_int(rf, 7),
        ))
    return SegmentData(
        seg_id=first_int(f, 1) - 1,
        total=first_int(f, 2),
        offset=first_int(f, 3),
        data=first_bytes(f, 4, b""),
        segments=segments,
        snap_epoch=first_int(f, 6),
        snap_seq=first_int(f, 7),
        trace_ctx=_dec_trace_ctx(f),
    )


def _enc_get_objects(m: GetObjects) -> bytes:
    e = Encoder()
    e.varint(1, 0)  # type otUNKNOWN
    e.boolean(2, True)  # query
    for h in m.hashes:
        e.message(6, Encoder().blob(1, h))
    return e.data()


def _enc_objects_data(m: ObjectsData) -> bytes:
    e = Encoder()
    e.varint(1, 0)
    e.boolean(2, False)  # reply
    for h, blob in m.objects:
        e.message(6, Encoder().blob(1, h).blob(4, blob))
    return e.data()


def _dec_get_objects(buf: bytes):
    f = parse(buf)
    objs = [parse(sub) for sub in f.get(6, [])]
    if first_int(f, 2):
        return GetObjects([first_bytes(of, 1) for of in objs])
    return ObjectsData(
        [(first_bytes(of, 1), first_bytes(of, 4)) for of in objs]
    )


# class -> (message type, encoder); one mt may decode to several classes
_ENCODERS = {
    Hello: (MessageType.HELLO, _enc_hello),
    Ping: (MessageType.PING, _enc_ping),
    ClusterStatus: (MessageType.CLUSTER, _enc_cluster),
    ClusterUpdate: (MessageType.CLUSTER, _enc_cluster_update),
    Endpoints: (MessageType.ENDPOINTS, _enc_endpoints),
    TxMessage: (MessageType.TRANSACTION, _enc_tx),
    GetLedger: (MessageType.GET_LEDGER, _enc_get_ledger),
    GetTxSet: (MessageType.GET_LEDGER, _enc_get_set),
    LedgerData: (MessageType.LEDGER_DATA, _enc_ledger_data),
    TxSetData: (MessageType.LEDGER_DATA, _enc_set_data),
    ProposeSet: (MessageType.PROPOSE_SET, _enc_propose),
    StatusChange: (MessageType.STATUS_CHANGE, _enc_status),
    HaveTxSet: (MessageType.HAVE_TX_SET, _enc_have_set),
    ValidationMessage: (MessageType.VALIDATION, _enc_validation),
    GetObjects: (MessageType.GET_OBJECTS, _enc_get_objects),
    ObjectsData: (MessageType.GET_OBJECTS, _enc_objects_data),
    GetSegments: (MessageType.GET_SEGMENTS, _enc_get_segments),
    SegmentData: (MessageType.SEGMENT_DATA, _enc_segment_data),
}

_DECODERS = {
    MessageType.HELLO: _dec_hello,
    MessageType.PING: _dec_ping,
    MessageType.CLUSTER: _dec_cluster,
    MessageType.ENDPOINTS: _dec_endpoints,
    MessageType.TRANSACTION: _dec_tx,
    MessageType.GET_LEDGER: _dec_get_ledger,
    MessageType.LEDGER_DATA: _dec_ledger_data,
    MessageType.PROPOSE_SET: _dec_propose,
    MessageType.STATUS_CHANGE: _dec_status,
    MessageType.HAVE_TX_SET: _dec_have_set,
    MessageType.VALIDATION: _dec_validation,
    MessageType.GET_OBJECTS: _dec_get_objects,
    MessageType.GET_SEGMENTS: _dec_get_segments,
    MessageType.SEGMENT_DATA: _dec_segment_data,
}


def encode_message(msg) -> bytes:
    """Payload bytes (no frame header)."""
    _mt, enc = _ENCODERS[type(msg)]
    return enc(msg)


# ripple.proto MessageType values we know of but do not implement:
# mtERROR_MSG, mtPROOFOFWORK(wire), presence/discovery legacy
# (mtGET_CONTACTS..mtUNUSED_FIELD), small-node ops
# (mtSEARCH_TRANSACTION..mtACCOUNT), mtGET_VALIDATIONS
_KNOWN_UNIMPLEMENTED = frozenset({2, 4, 10, 11, 12, 13, 14, 20, 21, 22, 40})


def decode_message(mt: int, payload: bytes):
    """Decode one payload. Schema-known message types outside our subset
    return None (skipped — a full-ripple.proto peer routinely sends
    them, and protobuf compatibility means never erroring on them); a
    type outside the schema entirely is a protocol violation and raises,
    so the resource plane can charge the sender (reference: PeerImp's
    invalid-message fee)."""
    if mt in _KNOWN_UNIMPLEMENTED:
        return None
    try:
        typ = MessageType(mt)
    except ValueError:
        raise ValueError(f"message type {mt} outside the wire schema") from None
    return _DECODERS[typ](payload)


def frame(msg) -> bytes:
    """Full wire frame: 4-byte length + 2-byte type + payload
    (reference: Message.cpp 6-byte header)."""
    mt, enc = _ENCODERS[type(msg)]
    payload = enc(msg)
    return len(payload).to_bytes(4, "big") + int(mt).to_bytes(2, "big") + payload


class FrameReader:
    """Incremental frame decoder for a TCP byte stream."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> list:
        """Append stream bytes; return completed messages."""
        self._buf.extend(data)
        out = []
        while len(self._buf) >= HEADER_LEN:
            length = int.from_bytes(self._buf[:4], "big")
            if length > MAX_FRAME:
                raise ValueError("oversized frame")
            if len(self._buf) < HEADER_LEN + length:
                break
            mt = int.from_bytes(self._buf[4:6], "big")
            payload = bytes(self._buf[HEADER_LEN : HEADER_LEN + length])
            del self._buf[: HEADER_LEN + length]
            msg = decode_message(mt, payload)
            if msg is not None:  # unknown type: skipped, stream continues
                out.append(msg)
        return out
