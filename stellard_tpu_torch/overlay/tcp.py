"""TCP overlay: real-socket peer sessions for a validator private net.

Reference: src/ripple_overlay/impl/{OverlayImpl,PeerImp}.cpp — inbound
door + outbound dials, per-peer handshake proving node-key ownership,
length-prefixed message framing, flood relay with HashRouter
suppression. The reference handshakes over anonymous SSL and signs the
SSL session fingerprint (PeerImp hello proof); without a vendored TLS
stack we exchange fresh random nonces and sign the hash of both, which
gives the same session-binding property on a trusted LAN. Validator
traffic rides this overlay; the signature and hash batches it gives the
node go to the card (K1 verifies every relayed transaction, proposal
and validation; K2/K3 hash tx sets and seals).

Threading model: one reader thread per peer plus a shared heartbeat
thread driving the consensus timer — the asio/JobQueue shape collapsed
onto the ValidatorNode's internal locking.
"""

from __future__ import annotations

import itertools
import logging
import os
import socket
import struct
import threading
import time
from typing import Callable, Optional

from ..consensus.consensus import ConsensusAdapter
from ..consensus.txset import TxSet
from ..consensus.validation import STValidation
from ..node.hashrouter import SF_RELAYED
from ..node.validator import ValidatorNode
from ..ops.build import is_device_error
from ..protocol.keys import KeyPair, verify_signature
from ..protocol.sttx import SerializedTransaction
from ..state.ledger import Ledger
from ..utils.hashes import prefix_hash
from .peerfinder import GOSSIP_INTERVAL, PeerFinder
from .resource import (
    Disposition,
    FEE_BAD_DATA,
    FEE_INVALID_REQUEST,
    FEE_INVALID_SIGNATURE,
    FEE_REQUEST_NO_REPLY,
    FEE_UNWANTED_DATA,
    ResourceManager,
)
from .squelch import SQUELCH_ROTATE, SQUELCH_SIZE, SquelchPolicy
from .wire import (
    ClusterStatus,
    ClusterUpdate,
    Endpoints,
    FrameReader,
    GetLedger,
    GetSegments,
    GetTxSet,
    Hello,
    LedgerData,
    Ping,
    ProposeSet,
    SegmentData,
    TraceContext,
    TxMessage,
    TxSetData,
    ValidationMessage,
    frame,
)

__all__ = ["DeviceFailed", "TcpOverlay"]

log = logging.getLogger("stellard.overlay")

PROTO_VERSION = 1
# domain prefix for the session-binding signature ("SSN\0")
HP_SESSION = (ord("S") << 24) | (ord("S") << 16) | (ord("N") << 8)


class DeviceFailed(RuntimeError):
    """The card failed under the overlay: a verify batch of a peer's
    pump (any error of the plane), or a device error in a message's
    handling or the consensus timer (a failed launch, a wedged card).
    It ends that thread's work, and its cause stays in
    ``TcpOverlay.device_error``, which the node raises: no
    per-transaction verify takes a failed batch's place."""


class _Peer:
    # bounded outbound queue: a peer that stops reading sheds here
    # instead of blocking the caller (consensus timer / relay threads
    # must NEVER wait on a socket — reference: PeerImp's async writes)
    SENDQ_DEPTH = 256
    # graceful degradation (the infosub sendq discipline applied to the
    # overlay): overflow drops the OLDEST queued frame — a slow reader
    # sees a gap its acquisition machinery repairs, never a stale
    # stream — and this many CONSECUTIVE overflow events evicts the
    # peer outright (it is wedged, not slow)
    EVICT_DROPS = 64
    # writer coalescing: drain up to this many queued bytes into ONE
    # sendall — a relay burst of small frames becomes one size-bounded
    # batch write instead of a syscall per frame
    WRITE_COALESCE = 256 * 1024

    # never-recycled session ids for HashRouter suppression sets (id()
    # can be reused by a later peer object within the router's 300s hold,
    # which would wrongly exclude a fresh peer from relays)
    _NEXT_UID = itertools.count(1)

    def __init__(self, sock: socket.socket, inbound: bool,
                 addr: Optional[tuple[str, int]] = None,
                 sendq_depth: Optional[int] = None,
                 evict_drops: Optional[int] = None):
        import queue

        if sendq_depth:
            self.SENDQ_DEPTH = int(sendq_depth)  # instance override
        if evict_drops:
            self.EVICT_DROPS = int(evict_drops)
        self.uid = next(_Peer._NEXT_UID)
        # serializes SSL_read/SSL_write on a TLS socket: one OpenSSL SSL*
        # must not run concurrent operations from two threads (the writer
        # thread sends while the session thread recvs). Plain sockets
        # don't take it — the kernel allows full-duplex concurrency.
        self.io_lock = threading.Lock()
        self.is_tls = False
        # slot accounting (reference Counts.h): reserved = fixed/cluster
        self.slot_reserved = False
        # real-clock establishment stamp (0.0 = never registered) and a
        # flag marking closes that must NOT trigger dial backoff
        self.established_mono = 0.0
        self.benign_close = False
        # acquisition scoring (reference: PeerSet peer selection): how
        # many ledger-data requests we routed here and how many replies
        # came back — the reply rate drives future routing
        self.acq_requests = 0
        self.acq_replies = 0
        self.sock = sock
        self.inbound = inbound
        self.addr = addr  # configured dial address (outbound only)
        self.reader = FrameReader()
        self.node_public: bytes = b""
        self.send_lock = threading.Lock()
        self.sendq: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=self.SENDQ_DEPTH
        )
        # sendq shedding evidence (aggregated into the overlay's
        # `resource`/`squelch` observability blocks)
        self.sendq_dropped = 0
        self._consec_drops = 0
        self.evicted = False
        self._writer: Optional[threading.Thread] = None
        self.alive = True
        self.established_at = 0.0
        # real wall-clock (not the node's virtual clock): socket liveness
        self.last_recv = time.monotonic()
        try:
            self.remote: tuple[str, int] = sock.getpeername()[:2]
        except OSError:
            self.remote = ("?", 0)
        # (remote_ip, their_listen_port) once the hello arrives — the
        # dialable identity of this peer for discovery
        self.advertised: Optional[tuple[str, int]] = None

    def send(self, data: bytes) -> None:
        """Non-blocking enqueue; the per-peer writer thread drains. A
        full queue sheds the OLDEST queued frame (never the sender's
        thread — the master lock may be held here); EVICT_DROPS
        consecutive overflows means the reader is wedged, not slow, and
        the peer is evicted so one dead peer can never hold a sendq's
        worth of every relay wave forever."""
        import queue

        if not self.alive:
            return
        if self._writer is None:
            with self.send_lock:
                if self._writer is None:
                    t = threading.Thread(
                        target=self._write_loop, name="peer-writer", daemon=True
                    )
                    self._writer = t
                    t.start()
        try:
            self.sendq.put_nowait(data)
        except queue.Full:
            self.sendq_dropped += 1
            self._consec_drops += 1
            if self._consec_drops >= self.EVICT_DROPS:
                self.evicted = True
                self.close()
                return
            try:
                self.sendq.get_nowait()  # drop-OLDEST
            except queue.Empty:
                pass
            try:
                self.sendq.put_nowait(data)
            except queue.Full:
                pass  # racing senders refilled it: this frame sheds
        else:
            self._consec_drops = 0

    def _write_loop(self) -> None:
        import queue

        while True:
            data = self.sendq.get()
            if data is None or not self.alive:
                return
            # coalesce a backlog burst into one bounded write: frames
            # are self-delimiting, so concatenation is free batching
            if len(data) < self.WRITE_COALESCE:
                chunks = [data]
                size = len(data)
                while size < self.WRITE_COALESCE:
                    try:
                        nxt = self.sendq.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:  # close sentinel: flush then exit
                        self._flush(b"".join(chunks))
                        return
                    chunks.append(nxt)
                    size += len(nxt)
                data = b"".join(chunks) if len(chunks) > 1 else data
            if not self._flush(data):
                return

    def _flush(self, data: bytes) -> bool:
        try:
            if self.is_tls:
                with self.io_lock:
                    self.sock.sendall(data)
            else:
                self.sock.sendall(data)  # SO_SNDTIMEO bounds each write
            return True
        except OSError:
            self.alive = False
            return False

    def recv_locked(self, bufsize: int = 65536) -> Optional[bytes]:
        """One recv honoring the TLS serialization rule. Returns None on
        a poll timeout (TLS path polls so the writer can interleave),
        b\"\" on EOF, data otherwise. Raises OSError on a dead socket."""
        if not self.is_tls:
            return self.sock.recv(bufsize)
        import ssl as _ssl

        try:
            with self.io_lock:
                return self.sock.recv(bufsize)
        except (TimeoutError, socket.timeout, _ssl.SSLWantReadError):
            return None

    def close(self) -> None:
        self.alive = False
        try:
            self.sendq.put_nowait(None)  # wake the writer
        except Exception:  # noqa: BLE001 — full queue: shutdown below aborts it
            pass
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _acq_score(p) -> tuple:
    """Ordering key for acquisition routing: better reply rate first,
    then fewer outstanding requests (min() picks the best)."""
    rate = (p.acq_replies + 1) / (p.acq_requests + 1)
    outstanding = p.acq_requests - p.acq_replies
    return (-rate, outstanding)


class TcpOverlay(ConsensusAdapter):
    """Peer-connection manager + the node's ConsensusAdapter."""

    def __init__(
        self,
        key: KeyPair,
        unl: set[bytes],
        quorum: int,
        port: int,
        peer_addrs: list[tuple[str, int]],
        network_time: Optional[Callable[[], int]] = None,
        clock: Optional[Callable[[], float]] = None,
        timer_interval: float = 1.0,
        idle_interval: int = 15,
        hash_batch: Optional[Callable] = None,
        peer_idle_ping: float = 9.0,
        peer_idle_drop: float = 30.0,
        out_desired: int = 8,
        max_peers: int = 21,
        bootcache_path: Optional[str] = None,
        resource_key_fn: Optional[Callable] = None,
        gossip_interval: float = GOSSIP_INTERVAL,
        unl_store=None,
        cluster: Optional[set[bytes]] = None,
        fee_track=None,
        verify_many: Optional[Callable] = None,
        proposing: bool = True,
        router=None,
        job_dispatch: Optional[Callable[[str, Callable], None]] = None,
        peer_tls=None,
        follower: bool = False,
        pinned_upstream: bool = False,
        squelch_size: int = SQUELCH_SIZE,
        squelch_rotate: int = SQUELCH_ROTATE,
        sendq_cap: int = 0,
        sendq_evict_drops: int = 0,
    ):
        self.key = key
        self.port = port
        self.peer_addrs = peer_addrs
        self.timer_interval = timer_interval
        self.peer_idle_ping = peer_idle_ping
        self.peer_idle_drop = peer_idle_drop
        self._clock = clock or time.monotonic
        self._ntime = network_time or (lambda: int(time.time()) - 946_684_800)
        self.node = ValidatorNode(
            key=key,
            unl=unl,
            adapter=self,
            quorum=quorum,
            network_time=self._ntime,
            clock=self._clock,
            idle_interval=idle_interval,
            hash_batch=hash_batch,
            verify_many=verify_many,
            proposing=proposing,
            router=router,
            follower=follower,
        )
        if unl_store is not None:
            # per-validator misbehavior bookkeeping: defense events with
            # an identified trusted signer land on its UNL row
            def _note_unl(kind: str, peer_pub: bytes) -> None:
                if peer_pub in unl_store:
                    unl_store.on_byzantine(peer_pub, kind)

            self.node.on_byzantine = _note_unl
        self.peers: dict[bytes, _Peer] = {}  # node pubkey -> session
        self._dialing: set[tuple[str, int]] = set()  # dials in flight
        # cascading follower tree ([node] upstream=): a pinned follower
        # dials ONLY its named upstreams — fixed seeds are always kept
        # connected, but out_desired=0 disables discovery dialing, so
        # gossip-learned endpoints (including the leader's) can never
        # re-flatten the tree; inbound children still attach freely
        self.pinned_upstream = bool(pinned_upstream)
        self.peerfinder = PeerFinder(
            fixed=peer_addrs,
            out_desired=0 if pinned_upstream else out_desired,
            max_peers=max_peers,
            bootcache_path=bootcache_path,
        )
        self.resources = ResourceManager(key_fn=resource_key_fn)
        # validator-message squelching ([overlay] squelch=): every relay
        # (and origin send) of a proposal/validation goes to the
        # deterministic rotating subset for its SIGNER instead of the
        # whole peer set; squelch_size=0 is the full-flood kill-switch
        self.squelch = SquelchPolicy(
            size=squelch_size, rotate=squelch_rotate,
            relayer_id=key.public,
        )
        self.sendq_cap = int(sendq_cap)
        self.sendq_evict_drops = int(sendq_evict_drops)
        # overlay defense evidence (`resource.*`/`squelch.*` naming,
        # doc/observability.md): relay fan-outs, throttled/dup sheds,
        # sendq drops/evictions — the counters scenario gates assert on
        from ..node.metrics import AtomicCounters

        self.overlay_stats = AtomicCounters(
            "relay_proposal", "relay_validation", "relay_fanout_max",
            "throttled_msgs", "dup_charges", "sendq_dropped",
            "sendq_evicted", "squelch_demoted",
        )
        # the hello's session-signature checks: host verifies of the
        # handshake (the reference's own), counted apart from the
        # relayed traffic's, which the verify plane answers
        self.handshake_stats = AtomicCounters("verifies")
        # the first error of the card under the overlay (DeviceFailed's
        # cause); the node raises it
        self.device_error: Optional[BaseException] = None
        self.unl_store = unl_store  # node.unl.UniqueNodeList or None
        # same-operator cluster (reference mtCLUSTER): members share their
        # load fee so the whole cluster escalates together
        self.cluster = cluster or set()
        self.fee_track = fee_track  # node.loadmgr.LoadFeeTrack or None
        # peer-message scheduler seam: when the application container
        # wires its JobQueue here, proposal/validation handling becomes
        # jtPROPOSAL_t/jtVALIDATION_t jobs (latency-tracked, sheddable);
        # bare overlays handle inline
        self.job_dispatch = job_dispatch
        # transport encryption (overlay/peertls.py). None = plaintext
        # (reference parity requires TLS: every reference peer link is
        # anonymous SSL, PeerImp.h:88-90); when set, outbound dials speak
        # TLS, inbound autodetects, and `peer_tls.required` refuses
        # plaintext peers
        self.peer_tls = peer_tls
        self.gossip_interval = gossip_interval
        self._last_gossip = 0.0
        self._peers_lock = threading.Lock()
        # our own addresses as learned from self-connects via gossiped
        # endpoints: never handed out, never redialed
        self._self_addrs: set[tuple[str, int]] = set()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._listener: Optional[socket.socket] = None

    # -- lifecycle --------------------------------------------------------

    def start(self, genesis_account: bytes, close_time: int = 0) -> None:
        self.node.start(genesis_account, close_time or self._ntime())
        self.start_network()

    def start_network(self) -> None:
        """Open the listener + dial/timer loops WITHOUT (re)creating the
        genesis ledger — the path for an application container whose
        LedgerMaster was already set up (fresh or loaded) by Node.setup."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", self.port))
        self._listener.listen(16)
        self._spawn(self._accept_loop)
        self._spawn(self._connect_loop)
        self._spawn(self._timer_loop)

    def stop(self) -> None:
        self._stop.set()
        try:
            self.peerfinder.bootcache.save()
        except OSError:
            pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._peers_lock:
            for p in list(self.peers.values()):
                p.close()
        with self._threads_lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)

    def _spawn(self, fn, *args) -> None:
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        with self._threads_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # -- session establishment -------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            self._spawn(self._session, sock, True)

    def _connect_loop(self) -> None:
        """Fill outbound slots from the PeerFinder's connect policy
        (reference: OverlayImpl autoconnect via PeerFinder::autoconnect):
        fixed seeds always, then gossip-discovered endpoints. Addresses
        with a live session (or a dial in flight) are skipped so an
        established connection is never churned by the redial timer."""
        while not self._stop.is_set():
            with self._peers_lock:
                connected = {
                    a
                    for p in self.peers.values()
                    if p.alive
                    for a in (p.addr, p.advertised)
                    if a is not None
                }
                dialing = set(self._dialing)
                out_count = sum(
                    1 for p in self.peers.values() if not p.inbound and p.alive
                )
                total = len(self.peers)
            # never dial ourselves (our own gossiped hop-0 endpoint,
            # plus any address a past self-connect proved is us)
            connected.add(("127.0.0.1", self.port))
            with self._peers_lock:
                connected |= self._self_addrs
            targets = self.peerfinder.dial_targets(
                connected, dialing, out_count, total
            )
            for addr in targets:
                with self._peers_lock:
                    if addr in self._dialing:
                        continue
                    self._dialing.add(addr)
                self._spawn(self._dial, addr)
            self._stop.wait(2.0)

    def _dial(self, addr: tuple[str, int]) -> None:
        try:
            sock = socket.create_connection(addr, timeout=2.0)
        except OSError:
            self.peerfinder.on_failure(addr)
            with self._peers_lock:
                self._dialing.discard(addr)
            return
        if self.peer_tls is not None:
            import ssl as _ssl

            sock.settimeout(5.0)
            try:
                sock = self.peer_tls.wrap_client(sock)
            except (OSError, _ssl.SSLError):
                try:
                    sock.close()
                except OSError:
                    pass
                if self.peer_tls.required:
                    self.peerfinder.on_failure(addr)
                    with self._peers_lock:
                        self._dialing.discard(addr)
                    return
                # allow mode: the remote may be a plaintext node that ate
                # our ClientHello as garbage — redial in the clear
                # (opportunistic encryption, mixed-net upgrades)
                try:
                    sock = socket.create_connection(addr, timeout=2.0)
                except OSError:
                    self.peerfinder.on_failure(addr)
                    with self._peers_lock:
                        self._dialing.discard(addr)
                    return
                self._session(sock, False, addr)
                return
            self._session(sock, False, addr, tls=True)
            return
        self._session(sock, False, addr)

    def _session(
        self,
        sock: socket.socket,
        inbound: bool,
        addr: Optional[tuple[str, int]] = None,
        tls: bool = False,
    ) -> None:
        """Nonce exchange → signed hello → message pump
        (reference: PeerImp::onHandshake/recvHello). Outbound TLS wrapping
        happens in _dial (where a failed handshake can fall back to a
        plaintext redial); inbound autodetects here."""
        peer = _Peer(sock, inbound, addr,
                     sendq_depth=self.sendq_cap,
                     evict_drops=self.sendq_evict_drops)
        peer.is_tls = tls
        try:
            if inbound and not self.resources.should_admit(peer.remote):
                # endpoint balance still above the drop line: refuse
                # reconnects until it decays (reference Logic::newInboundEndpoint)
                self.resources.note_refused(peer.remote)
                peer.close()
                return
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            sock.settimeout(5.0)
            if self.peer_tls is not None and inbound:
                # SSL-or-plain autodetect (reference: MultiSocket)
                if self.peer_tls.is_tls_client_hello(sock):
                    sock = self.peer_tls.wrap_server(sock)
                    peer.sock = sock  # writer/pump/close use the TLS socket
                    peer.is_tls = True
                elif self.peer_tls.required:
                    peer.close()  # plaintext peer refused
                    return
            if peer.is_tls:
                # from here on the writer thread (hello send onward) and
                # this session thread share one SSL object: reads poll on
                # a short timeout so the io_lock is released regularly
                sock.settimeout(0.05)
            # first nonce byte must not collide with the TLS handshake
            # record type (0x16) or the remote's autodetect would
            # misclassify this plaintext session
            nonce = os.urandom(32)
            while nonce[0] == 0x16:
                nonce = os.urandom(32)
            sock.sendall(nonce)
            their_nonce = self._read_exact(sock, 32)
            # session binding the hello signature proves: both nonces
            # plus (when encrypted) the RFC 5929 tls-unique value of THIS
            # TLS session — a terminating MITM's two legs have different
            # bindings, so its spliced hellos fail verification
            # (reference: node-key proof of the SSL session fingerprint)
            binding = (
                self.peer_tls.channel_binding(sock)
                if (self.peer_tls is not None and peer.is_tls)
                else b""
            )
            session_hash = prefix_hash(
                HP_SESSION,
                min(nonce, their_nonce) + max(nonce, their_nonce) + binding,
            )
            lcl = self.node.lm.closed_ledger()
            hello = Hello(
                PROTO_VERSION,
                self._ntime(),
                self.key.public,
                self.key.sign(session_hash),
                lcl.seq,
                lcl.hash(),
                self.port,
            )
            peer.send(frame(hello))
            their_hello = self._read_hello(sock, peer)
            if their_hello is None:
                peer.close()
                return
            self.handshake_stats.add("verifies")
            if not verify_signature(
                their_hello.node_public, session_hash, their_hello.session_sig
            ):
                self._charge(peer, FEE_INVALID_SIGNATURE)
                peer.close()
                return
            if their_hello.proto_version != PROTO_VERSION:
                # protocol version skew: refuse cleanly (reference: TMHello
                # version gate in PeerImp::recvHello)
                peer.close()
                return
            if their_hello.node_public == self.key.public:
                # connected to ourselves via a gossiped address: drop,
                # blacklist in the bootcache, and remember it as a SELF
                # address so it is never handed out or redialed
                if addr is not None:
                    self.peerfinder.on_failure(addr)
                    with self._peers_lock:
                        self._self_addrs.add(addr)
                peer.close()
                return
            peer.node_public = their_hello.node_public
            if 0 < their_hello.listen_port < 65536:
                peer.advertised = (peer.remote[0], their_hello.listen_port)
                self.peerfinder.bootcache.insert(peer.advertised)
            if not inbound and addr is not None:
                self.peerfinder.on_success(addr)
            now = self._clock()
            refused = False
            with self._peers_lock:
                if inbound:
                    # slot admission in the SAME critical section as the
                    # registration below, so concurrent handshakes cannot
                    # all see a free slot (reference: peerfinder Counts.h
                    # accounting). Reserved (fixed/cluster) peers bypass
                    # the cap and are excluded from in_count, so they
                    # never starve the ordinary inbound budget.
                    fixed = set(map(tuple, self.peerfinder.fixed))
                    reserved = (
                        peer.node_public in self.cluster
                        or (
                            peer.advertised is not None
                            and peer.advertised in fixed
                        )
                    )
                    in_count = sum(
                        1
                        for pub, p in self.peers.items()
                        if p.inbound
                        and p.alive
                        and not p.slot_reserved
                        and pub != peer.node_public
                    )
                    if not self.peerfinder.can_accept_inbound(
                        in_count, reserved
                    ):
                        refused = True
                    else:
                        peer.slot_reserved = reserved
                if not refused:
                    existing = self.peers.get(peer.node_public)
                    if existing is not None:
                        young = (
                            existing.alive
                            and now - existing.established_at <= 5.0
                        )
                        fresh = (
                            existing.alive
                            and time.monotonic() - existing.last_recv
                            <= self.peer_idle_ping
                        )
                        if young:
                            # simultaneous-connect race: the smaller key's
                            # dial wins, deterministically on both sides
                            if (self.key.public < peer.node_public) == inbound:
                                if existing.addr is None:
                                    existing.addr = peer.addr
                                peer.benign_close = True
                                peer.close()
                                return
                        elif fresh:
                            # existing session demonstrably alive (recent
                            # recv): keep it; learn the dial addr so
                            # _connect_loop stops redialing an
                            # inbound-only pair
                            if existing.addr is None:
                                existing.addr = peer.addr
                            peer.benign_close = True
                            peer.close()
                            return
                        # else: existing is likely half-open (crashed
                        # peer) — the fresh authenticated session
                        # displaces it; worst case a restarted peer waits
                        # one idle-ping window
                        if peer.addr is None:
                            peer.addr = existing.addr
                        existing.close()
                    peer.established_at = now
                    peer.established_mono = time.monotonic()
                    self.peers[peer.node_public] = peer
                    self.squelch.bump()  # peer churn re-ranks subsets
                exclude = set(self._self_addrs)
            if refused:
                # inbound slots exhausted: REDIRECT the connector to
                # better targets instead of silently dropping it
                # (reference ConnectHandouts.cpp / doRedirect), then
                # close. Never hand out our own addresses or the
                # connector's own.
                exclude.add(("127.0.0.1", self.port))
                if peer.advertised is not None:
                    exclude.add(peer.advertised)
                sample = self.peerfinder.handout(exclude=exclude)
                if sample:
                    data = frame(
                        Endpoints([(h, pt, 1) for h, pt in sample])
                    )
                    try:
                        if peer.is_tls:
                            with peer.io_lock:
                                sock.sendall(data)
                        else:
                            sock.sendall(data)
                    except OSError:
                        pass
                peer.close()
                return
            if not peer.is_tls:
                sock.settimeout(None)  # TLS keeps its 0.05s poll timeout
            # bounded sends only (SO_SNDTIMEO applies to send, not recv):
            # a stalled peer with a full kernel buffer must never block the
            # heartbeat/relay threads forever — sendall times out, send()
            # marks the peer dead, the session cleans up
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                struct.pack("ll", 10, 0),
            )
            self._pump(peer)
        except OSError:
            pass
        except ValueError:
            # malformed frame / unknown message type (version skew): charge
            # and close this peer cleanly instead of killing the reader
            # thread (reference: PeerImp charge(feeInvalidRequest))
            self.node.note_byzantine(
                "malformed_frame", peer=peer.node_public or None
            )
            self._charge(peer, FEE_INVALID_REQUEST)
        finally:
            with self._peers_lock:
                if self.peers.get(peer.node_public) is peer:
                    del self.peers[peer.node_public]
                    self.squelch.bump()
                if peer.addr is not None:
                    self._dialing.discard(peer.addr)
            if peer.sendq_dropped or peer.evicted:
                self.overlay_stats.add_many(
                    sendq_dropped=peer.sendq_dropped,
                    sendq_evicted=1 if peer.evicted else 0,
                )
            peer.close()
            # a dial whose session never established (refused handshake,
            # slot redirect) or died within seconds must BACK OFF instead
            # of re-handshaking every connect-loop tick; benign closes
            # (duplicate-session handling) are exempt
            if (
                not inbound
                and addr is not None
                and not peer.benign_close
                and not self._stop.is_set()
                and (
                    peer.established_mono == 0.0
                    or time.monotonic() - peer.established_mono < 3.0
                )
            ):
                self.peerfinder.on_failure(addr)

    def slots_json(self) -> dict:
        """Slot accounting for the peers RPC (reference: Counts in the
        peerfinder section of the peers response)."""
        with self._peers_lock:
            in_use = sum(1 for p in self.peers.values() if p.inbound and p.alive)
            out_use = sum(
                1 for p in self.peers.values() if not p.inbound and p.alive
            )
            cluster = sum(
                1
                for pub, p in self.peers.items()
                if p.alive and pub in self.cluster
            )
        d = self.peerfinder.get_json()
        d.update({"in_use": in_use, "out_use": out_use, "cluster_use": cluster})
        return d

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        """Handshake-phase read (single-threaded: the writer thread is
        not live yet, so no io_lock needed). Poll timeouts retry up to a
        10s deadline; a dead peer raises OSError."""
        import ssl as _ssl

        deadline = time.monotonic() + 10.0
        buf = b""
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except (TimeoutError, socket.timeout, _ssl.SSLWantReadError):
                if time.monotonic() > deadline:
                    raise OSError("handshake read timed out")
                continue
            if not chunk:
                raise OSError("peer closed")
            buf += chunk
        return buf

    def _read_hello(self, sock: socket.socket, peer: _Peer) -> Optional[Hello]:
        # the writer thread is live from our own hello send onward, so
        # reads go through the TLS-serializing recv; bounded overall
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            data = peer.recv_locked()
            if data is None:
                continue  # TLS poll timeout
            if not data:
                return None
            msgs = peer.reader.feed(data)
            if msgs:
                return msgs[0] if isinstance(msgs[0], Hello) else None
        return None

    # -- message pump -----------------------------------------------------

    def _pump(self, peer: _Peer) -> None:
        while not self._stop.is_set() and peer.alive:
            try:
                data = peer.recv_locked()
            except OSError:
                return
            if data is None:
                continue  # TLS poll timeout — let the writer in
            if not data:
                return
            peer.last_recv = time.monotonic()
            msgs = list(peer.reader.feed(data))
            # WARN throttling (enforced resource pricing): while this
            # endpoint's balance sits above the warning line its
            # NON-ESSENTIAL inbound is shed before any parse/verify work
            # — tx gossip, endpoint gossip, and bulk-serving requests.
            # Consensus messages (proposals/validations/acquisition
            # replies) still flow: throttling a warned-but-honest peer
            # must degrade its gossip, never the network's liveness.
            if msgs and self.resources.is_throttled(peer.remote):
                kept = [
                    m for m in msgs
                    if not isinstance(m, (TxMessage, Endpoints, GetSegments,
                                          GetLedger))
                ]
                if len(kept) != len(msgs):
                    n_shed = len(msgs) - len(kept)
                    self.resources.note_throttled(n_shed)
                    self.overlay_stats.add("throttled_msgs", n_shed)
                    msgs = kept
                    # shed traffic still pays (reference: discarded
                    # data is charged feeUnwantedData): a flooder that
                    # keeps sending through its WARN throttle walks on
                    # to DROP instead of parking at WARN forever
                    from .resource import Charge

                    self._charge(peer, Charge(
                        FEE_UNWANTED_DATA.cost * n_shed, "throttled flood"
                    ))
            # a single read often carries a burst of relayed txs: parse
            # each ONCE and verify their signatures in one plane call
            # before dispatching (an unparseable tx stays None here and
            # raises inside _dispatch, where the sender is charged)
            parsed_txs: dict[int, SerializedTransaction] = {}
            first_seen: dict[int, bool] = {}
            if sum(1 for m in msgs if isinstance(m, TxMessage)) > 1:
                for i, m in enumerate(msgs):
                    if isinstance(m, TxMessage):
                        try:
                            parsed_txs[i] = (
                                SerializedTransaction.from_bytes(m.blob)
                            )
                        except Exception:  # noqa: BLE001 — charged below
                            pass
                # suppression BEFORE the prefetch: the prefetch records
                # each verdict in the HashRouter, after which every tx
                # of this read would look already seen and be neither
                # applied nor relayed (the JAX pump's order loses every
                # tx of a read that carries two or more). Only the new
                # ones are verified.
                for i, tx in parsed_txs.items():
                    first_seen[i] = self._first_seen(tx.txid(), peer)
                # an error of the verify plane propagates: no per-tx
                # path verifies in its place
                try:
                    self.node.prefetch_tx_sigs(
                        [tx for i, tx in parsed_txs.items() if first_seen[i]]
                    )
                except Exception as exc:
                    raise self._device_failed(exc) from exc
            for i, msg in enumerate(msgs):
                try:
                    self._dispatch(peer, msg, parsed_tx=parsed_txs.get(i),
                                   first_seen=first_seen.get(i))
                except Exception as exc:  # noqa: BLE001 — a malformed
                    # message (unparseable blob, absurd nesting, handler
                    # bug) must charge the SENDER, never kill our own
                    # pump thread (reference: PeerImp catches per message
                    # and charges feeBadData); an error of the card ends
                    # the session instead
                    if is_device_error(exc):
                        raise self._device_failed(exc) from exc
                    log.exception(
                        "peer %s: dispatch failed for %s",
                        peer.remote, type(msg).__name__,
                    )
                    self._charge(peer, FEE_BAD_DATA)

    def _device_failed(self, exc: BaseException) -> DeviceFailed:
        """Keep the card's first error for the node and return the error
        that ends the failing thread's work."""
        with self._peers_lock:
            if self.device_error is None:
                self.device_error = exc
        return DeviceFailed(f"the card failed under the overlay: {exc!r}")

    def _device_guarded(self, fn: Callable) -> None:
        """Run ``fn``; a device error in it is kept for the node (a job
        queue or a thread would otherwise only print it) and re-raised."""
        try:
            fn()
        except Exception as exc:
            if is_device_error(exc):
                raise self._device_failed(exc) from exc
            raise

    @property
    def handshake_verifies(self) -> int:
        """Host verifies of hello session signatures so far."""
        return self.handshake_stats.get("verifies")

    def _charge(self, peer: _Peer, fee) -> None:
        """Charge the peer's endpoint; disconnect on DROP (reference:
        PeerImp.cpp:129-131 charge(feeInvalidSignature) → Logic drop).
        The dropped endpoint then stays refused at inbound admission
        (should_admit in _session) until its balance decays."""
        if self.resources.charge(peer.remote, fee) == Disposition.DROP:
            self.resources.note_disconnect()
            peer.close()

    def _charge_if_bad(self, peer: _Peer, suppression_id: bytes) -> None:
        """After a handler rejected a message: if the HashRouter marked it
        SF_BAD the signature was invalid (not merely duplicate) — that is
        the chargeable offense."""
        from ..node.hashrouter import SF_BAD

        if self.node.router.get_flags(suppression_id) & SF_BAD:
            self._charge(peer, FEE_INVALID_SIGNATURE)

    def _adopt_ctx(self, msg) -> None:
        """Inbound trace-context handling (Dapper propagation): when the
        extension is present and propagation is on, register the sender's
        span as the foreign parent for that trace so every local span
        joins the sender's causal tree; when propagation is off, STRIP
        the extension so any re-relayed frame is byte-identical to the
        legacy wire."""
        ctx = getattr(msg, "trace_ctx", None)
        if ctx is None:
            return
        tracer = self.node.lm.tracer
        if not (tracer.enabled and tracer.propagate):
            msg.trace_ctx = None
            return
        if ctx.sampled:
            tracer.adopt_context(tracer.trace_key(ctx.trace), ctx.parent)

    def _stamp_ctx(self, msg, txid=None, seq=None) -> None:
        """Stamp an ORIGIN frame with this node's trace context. Relayed
        frames are never restamped — every flooded copy of a message must
        stay byte-identical so content-hash dedup keeps working."""
        ctx = self.node.lm.tracer.wire_context(txid=txid, seq=seq)
        if ctx is not None:
            msg.trace_ctx = TraceContext(*ctx)

    def _dispatch(self, peer: _Peer, msg, parsed_tx=None,
                  first_seen: Optional[bool] = None) -> None:
        """reference: PeerImp message switch (PeerImp.cpp:1459-1738) —
        verify → apply → relay-if-new, charging abusive senders.
        ``first_seen`` is a TxMessage's suppression verdict when the pump
        took it before its batched prefetch."""
        node = self.node
        self._adopt_ctx(msg)
        if isinstance(msg, TxMessage):
            tx = (parsed_tx if parsed_tx is not None
                  else SerializedTransaction.from_bytes(msg.blob))
            txid = tx.txid()
            if first_seen is None:
                first_seen = self._first_seen(txid, peer)
            if first_seen:
                # trace root for an overlay-relayed tx: the first sighting
                # on this node (the local-submit root is NetworkOPs')
                node.lm.tracer.instant(
                    "overlay.tx_in", "submit", txid=txid,
                    peer=peer.remote[0] if peer.remote else None,
                )
                if node.handle_tx(tx):
                    self._relay_tx_once(msg, txid)
                else:
                    self._charge_if_bad(peer, txid)
        elif isinstance(msg, ProposeSet):
            prop = msg.to_proposal()
            pid = prop.suppression_id()
            if self._first_seen(pid, peer):
                # handling (sig check + round routing) rides a
                # jtPROPOSAL_t job when a scheduler is wired (reference:
                # PeerImp::recvPropose queues checkPropose); inline
                # otherwise (bare-overlay tests)
                def do_proposal(prop=prop, pid=pid, peer=peer, msg=msg):
                    if node.handle_proposal(prop):
                        self._relay_validator_msg(
                            msg, prop.node_public, except_peer=peer,
                            kind="relay_proposal",
                        )
                    else:
                        self._charge_if_bad(peer, pid)

                self._schedule("proposal", do_proposal)
        elif isinstance(msg, ValidationMessage):
            val = STValidation.from_bytes(msg.blob)
            vid = val.validation_id()
            if self._first_seen(vid, peer):
                # jtVALIDATION_t job when scheduled (reference:
                # PeerImp::recvValidation → checkValidation job)
                def do_validation(val=val, vid=vid, peer=peer, msg=msg):
                    if node.handle_validation(val):
                        if (
                            self.unl_store is not None
                            and val.signer in self.unl_store
                        ):
                            # observed-validation bookkeeping (the modern
                            # unl_score: UniqueNodeList.on_validation)
                            self.unl_store.on_validation(
                                val.signer, val.ledger_seq
                            )
                        self._relay_validator_msg(
                            msg, val.signer or b"", except_peer=peer,
                            kind="relay_validation",
                        )
                    else:
                        self._charge_if_bad(peer, vid)

                self._schedule("validation", do_validation)
        elif isinstance(msg, ClusterUpdate):
            # TMCluster carries one entry per cluster node the sender
            # knows; we accept only reports about cluster members, and
            # the sender's own entry must come from the sender itself
            if self.fee_track is not None and peer.node_public in self.cluster:
                for st in msg.nodes:
                    # never ingest a relayed report about OURSELVES as a
                    # "remote" fee — that self-echo would ratchet
                    # local_fee's own report back onto us forever
                    if (
                        st.node_public in self.cluster
                        and st.node_public != self.key.public
                    ):
                        self.fee_track.set_remote_fee(
                            st.load_fee,
                            source=st.node_public,
                            report_time=st.report_time,
                        )
        elif isinstance(msg, Endpoints):
            accepted = self.peerfinder.on_endpoints(
                msg.endpoints, sender=peer.remote
            )
            if accepted <= 0:  # oversized (-1) or all-garbage (0)
                self._charge(peer, FEE_UNWANTED_DATA)
        elif isinstance(msg, TxSetData):
            from ..consensus.txset import MAX_TXSET_BLOBS

            if len(msg.tx_blobs) > MAX_TXSET_BLOBS:
                # oversized candidate set: refused before parsing a
                # single blob — one message must not buy O(huge) work
                node.note_byzantine(
                    "oversized_txset", peer=peer.node_public or None
                )
                self._charge(peer, FEE_BAD_DATA)
                return
            ts = TxSet(node.hash_batch)
            intact = True
            for blob in msg.tx_blobs:
                try:
                    tx = SerializedTransaction.from_bytes(blob)
                except Exception:  # noqa: BLE001 — hostile blob
                    intact = False
                    break
                ts.add(tx.txid(), blob)
            if intact and ts.hash() == msg.set_hash:
                node.handle_txset(ts)
            else:
                node.note_byzantine(
                    "txset_mismatch", peer=peer.node_public or None
                )
                self._charge(peer, FEE_BAD_DATA)
        elif isinstance(msg, GetTxSet):
            ts = node.txset_cache.get(msg.set_hash)
            if ts is None and node.round is not None:
                ts = node.round.acquired.get(msg.set_hash)
            if ts is not None:
                blobs = [blob for _t, blob in ts.blobs()]
                peer.send(frame(TxSetData(msg.set_hash, blobs)))
            else:
                # unsatisfiable request: a tiny charge an honest prober
                # never notices but a request-hammer accumulates
                # (reference: charge(feeRequestNoReply))
                self._charge(peer, FEE_REQUEST_NO_REPLY)
        elif isinstance(msg, GetLedger):
            reply = node.serve_get_ledger(msg)
            if reply is not None:
                peer.send(frame(reply))
            else:
                self._charge(peer, FEE_REQUEST_NO_REPLY)
        elif isinstance(msg, GetSegments):
            reply = node.serve_get_segments(msg)
            if reply is not None:
                if msg.trace_ctx is not None:
                    # reply joins the requester's tree (its ctx survived
                    # _adopt_ctx only when propagation is on here)
                    reply.trace_ctx = msg.trace_ctx
                peer.send(frame(reply))
            else:
                self._charge(peer, FEE_REQUEST_NO_REPLY)
        elif isinstance(msg, SegmentData):
            node.handle_segment_data(peer.node_public, msg)
        elif isinstance(msg, LedgerData):
            # only replies that actually advanced an acquisition score —
            # unsolicited LedgerData must not buy routing preference.
            # Duplicates for LIVE acquisitions are legitimate (we fan
            # out); data for unknown hashes earns a small charge
            if node.handle_ledger_data(msg):
                peer.acq_replies += 1
            elif not node.has_acquisition(msg.ledger_hash):
                self._charge(peer, FEE_UNWANTED_DATA)
        elif isinstance(msg, Ping) and not msg.is_pong:
            peer.send(frame(Ping(True, msg.seq)))

    def _first_seen(self, h: bytes, peer: _Peer) -> bool:
        """HashRouter relay suppression (reference: addSuppressionPeer)
        with re-send pricing: an honest mesh delivers each hash at most
        once per neighbor, so the SAME peer re-sending a suppressed hash
        is the duplicate-flood signature and takes FEE_UNWANTED_DATA
        (cross-peer duplicates — normal flood overlap — stay free)."""
        is_new, same_peer_dup = self.node.router.note_peer(h, peer.uid)
        if same_peer_dup:
            self.overlay_stats.add("dup_charges")
            self._charge(peer, FEE_UNWANTED_DATA)
        return is_new

    def _schedule(self, kind: str, thunk: Callable) -> None:
        if self.job_dispatch is not None:
            self.job_dispatch(kind, lambda: self._device_guarded(thunk))
        else:
            thunk()

    def _relay(self, msg, except_peer: Optional[_Peer] = None) -> None:
        data = frame(msg)
        with self._peers_lock:
            targets = [
                p for p in self.peers.values() if p is not except_peer
            ]
        for p in targets:
            p.send(data)

    def _broadcast(self, msg) -> None:
        self._relay(msg, None)

    def _squelch_targets(
        self, signer: bytes, except_peer: Optional[_Peer] = None
    ) -> list:
        """Relay targets for one validator's message: the deterministic
        rotating subset for (signer, epoch) plus every trusted-validator
        peer; untrusted signers are demoted (smaller subset, no forced
        validator inclusion). squelch off → all peers (full flood).

        The subset is computed over the FULL peer set and the sending
        peer filtered from the RESULT — excluding it from the ranking
        input would alias the subset memo across different senders
        (same candidate count, different members), relaying messages
        back to their own sender for a whole epoch."""
        with self._peers_lock:
            peers = [p for p in self.peers.values() if p.alive]
        if not self.squelch.enabled:
            return [p for p in peers if p is not except_peer]
        unl = self.node.unl
        demoted = bool(signer) and signer not in unl
        if demoted:
            self.overlay_stats.add("squelch_demoted")
        seq = self.node.lm.closed_ledger().seq
        subset = self.squelch.subset(
            signer, seq, peers,
            key_fn=lambda p: p.node_public,
            trusted=lambda p: p.node_public in unl,
            demoted=demoted,
        )
        return [p for p in subset if p is not except_peer]

    def _relay_validator_msg(
        self, msg, signer: bytes,
        except_peer: Optional[_Peer] = None,
        kind: str = "relay_proposal",
    ) -> None:
        """Squelched relay of a proposal/validation (reference overlay
        squelching role): fan-out bounded by the squelch subset size
        plus the UNL peer count, never by the peer count."""
        targets = self._squelch_targets(signer, except_peer)
        if not targets:
            return
        data = frame(msg)
        for p in targets:
            p.send(data)
        stats = self.overlay_stats
        stats.add(kind)
        if len(targets) > stats.get("relay_fanout_max"):
            stats.set("relay_fanout_max", len(targets))

    # -- timer ------------------------------------------------------------

    def _timer_loop(self) -> None:
        ping_seq = 0
        while not self._stop.wait(self.timer_interval):
            self._device_guarded(self.node.on_timer)
            # ENDPOINTS gossip: advertise our own listener (hop 0, host
            # rewritten to the observed IP by the receiver) plus a bounded
            # re-share of fresh livecache entries (reference mtENDPOINTS,
            # PeerSlotLogic::sendEndpoints)
            mono = time.monotonic()
            if mono - self._last_gossip >= self.gossip_interval:
                self._last_gossip = mono
                # a pinned-upstream follower never advertises its own
                # listener: its children find it via explicit upstream=
                # config, and an advertised endpoint would invite the
                # wider net (the leader included) to dial down into the
                # tree, un-bounding the very egress the tree bounds
                own = (
                    None if self.pinned_upstream
                    else ("0.0.0.0", self.port)
                )
                sample = self.peerfinder.gossip_sample(own)
                if sample:
                    self._broadcast(Endpoints(sample))
                if self.fee_track is not None and self.cluster:
                    # our own entry plus every unexpired report we hold —
                    # cluster members relay the full picture (reference:
                    # TMCluster carries all known ClusterNodeStatus rows)
                    now_nt = self._ntime()
                    nodes = [ClusterStatus(
                        self.key.public, self.fee_track.local_fee, now_nt,
                    )]
                    # relay stored reports with their ORIGINAL report_time
                    # (re-stamping would let two members refresh each
                    # other's stale entries forever — reference TMCluster
                    # carries the reporter's own reportTime)
                    for src, fee, rtime in self.fee_track.remote_reports():
                        if src in self.cluster and src != self.key.public:
                            nodes.append(ClusterStatus(src, fee, rtime))
                    status = frame(ClusterUpdate(nodes))
                    with self._peers_lock:
                        members = [
                            p for p in self.peers.values()
                            if p.node_public in self.cluster
                        ]
                    for p in members:
                        p.send(status)
                self.resources.sweep()
            if self.fee_track is not None:
                # aggregate peer pressure → local fee: while the peer
                # set as a whole is paying charges, the open-ledger
                # price rises (NORMAL_FEE x pressure, pressure = total
                # balance / WARN threshold) and decays with the
                # balances — network-wide abuse costs the abusers
                from ..node.loadmgr import NORMAL_FEE

                pressure = self.resources.aggregate_pressure()
                self.fee_track.set_network_pressure(
                    int(NORMAL_FEE * max(1.0, pressure))
                )
            # Half-open detection: a crashed peer (no FIN/RST) leaves our
            # reader blocked in recv with alive=True forever, which would
            # also suppress redials. Ping idle peers; drop ones silent past
            # the real-time threshold so the session cleans up and the
            # connect loop can redial (reference: PeerImp NO_PING timeout).
            now = time.monotonic()
            with self._peers_lock:
                peers = list(self.peers.values())
            for p in peers:
                idle = now - p.last_recv
                if idle > self.peer_idle_drop:
                    p.close()
                elif idle > self.peer_idle_ping:
                    ping_seq += 1
                    p.send(frame(Ping(False, ping_seq)))

    # -- ConsensusAdapter -------------------------------------------------

    def propose(self, proposal) -> None:
        # own proposals ride the same squelched fan-out as relays: at
        # production peer counts a validator's origin broadcast is the
        # other O(peers) send path, and the gossip subsets carry the
        # message the rest of the way
        msg = ProposeSet.from_proposal(proposal)
        rnd = self.node.round
        if rnd is not None:
            self._stamp_ctx(msg, seq=getattr(rnd, "seq", None))
        self._relay_validator_msg(
            msg, self.key.public, kind="relay_proposal",
        )

    def share_tx_set(self, txset: TxSet) -> None:
        blobs = [blob for _t, blob in txset.blobs()]
        self._broadcast(TxSetData(txset.hash(), blobs))

    def acquire_tx_set(self, set_hash: bytes) -> Optional[TxSet]:
        ts = self.node.txset_cache.get(set_hash)
        if ts is None:
            self._broadcast(GetTxSet(set_hash))  # async acquisition
        return ts

    def send_validation(self, val: STValidation) -> None:
        self.node.router.set_flag(val.validation_id(), SF_RELAYED)
        msg = ValidationMessage(val.serialize())
        self._stamp_ctx(msg, seq=val.ledger_seq)
        self._relay_validator_msg(
            msg, self.key.public, kind="relay_validation",
        )

    def relay_disputed_tx(self, blob: bytes) -> None:
        """Relay a disputed tx unless this node relayed it already (the
        JAX overlay broadcast it again to every peer, each of which had
        sent or been sent it, and charged each such re-send as a
        duplicate flood)."""
        msg = TxMessage(blob)
        try:
            txid = SerializedTransaction.from_bytes(blob).txid()
        except Exception:  # noqa: BLE001 — an unparseable dispute blob
            return         # is never relayed
        if self.node.lm.tracer.propagate:
            self._stamp_ctx(msg, txid=txid)
        self._relay_tx_once(msg, txid)

    def _relay_tx_once(self, msg: TxMessage, txid: bytes) -> None:
        """Relay a tx frame at most once a txid, to the peers it has not
        arrived from (the SF_RELAYED swap_set gate of the door's
        NetworkOPs.relay_applied; reference: HashRouter::swapSet before
        every relay). An honest node then never sends a peer the same tx
        twice, which that peer would charge as a duplicate flood."""
        prev_peers, newly = self.node.router.swap_set(txid, set(), SF_RELAYED)
        if not newly:
            return
        data = frame(msg)
        with self._peers_lock:
            targets = [p for p in self.peers.values() if p.uid not in prev_peers]
        for p in targets:
            p.send(data)

    def request_ledger_data(self, msg: GetLedger) -> None:
        """Anycast to the best-scoring connected peer (reference:
        PeerSet's peer selection): highest observed reply rate, fewest
        outstanding requests; every 8th request explores round-robin so
        fresh peers earn a score and a decayed one can recover."""
        with self._peers_lock:
            peers = [p for _k, p in sorted(self.peers.items()) if p.alive]
        if not peers:
            return
        self._acq_rr = getattr(self, "_acq_rr", 0) + 1
        if self._acq_rr % 8 == 0:
            target = peers[(self._acq_rr // 8) % len(peers)]
        else:
            target = min(peers, key=_acq_score)
        target.acq_requests += 1
        target.send(frame(msg))

    # segment catch-up transport hooks (node/inbound.SegmentCatchup)

    def segment_peers(self) -> list[bytes]:
        """Stable-ordered candidate peers for bulk segment transfer.
        Unified scoring: an endpoint at WARN or worse (charged for
        garbage, floods, or a condemned transfer) loses the catch-up
        privilege along with its relay/admission standing."""
        with self._peers_lock:
            cands = [
                (pub, self.peers[pub].remote)
                for pub in sorted(self.peers)
                if self.peers[pub].alive
            ]
        return [
            pub for pub, remote in cands
            if not self.resources.is_throttled(remote)
        ]

    def charge_peer(self, peer_pub: bytes, fee) -> str:
        """Charge a peer identified by node key (the SegmentCatchup
        condemnation seam): returns the Disposition; DROP disconnects,
        and the endpoint stays refused at inbound admission until its
        balance decays."""
        with self._peers_lock:
            p = self.peers.get(peer_pub)
        if p is None:
            return Disposition.OK
        disp = self.resources.charge(p.remote, fee)
        if disp == Disposition.DROP:
            self.resources.note_disconnect()
            p.close()
        return disp

    def send_segments_request(self, peer_pub: bytes, msg) -> None:
        with self._peers_lock:
            p = self.peers.get(peer_pub)
        if p is None or not p.alive:
            raise OSError("segment peer gone")
        if getattr(msg, "trace_ctx", None) is None:
            # best-effort: the catch-up trace is this node's ledger line
            self._stamp_ctx(msg, seq=self.node.lm.closed_ledger().seq)
        p.acq_requests += 1
        p.send(frame(msg))

    def on_accepted(self, ledger: Ledger, round_ms: int) -> None:
        self.node.round_accepted(ledger, round_ms)

    @property
    def accepted_hooks(self) -> list:
        """Ledger hooks live on the ValidatorNode (fired for consensus
        closes AND catch-up adoptions); exposed here for the container."""
        return self.node.on_ledger

    # -- client entry -----------------------------------------------------

    def submit_client_tx(self, tx: SerializedTransaction) -> None:
        self.node.submit(tx)
        msg = TxMessage(tx.serialize())
        self._stamp_ctx(msg, txid=tx.txid())
        self._broadcast(msg)

    def broadcast_tx(self, tx: SerializedTransaction, except_ids=None) -> None:
        """Relay an already-applied client tx (the NetworkOPs relay seam).
        `except_ids` is the HashRouter suppression peer-id set — peers the
        tx already arrived FROM are excluded from the fan-out (reference:
        the swapSet peer set drives exactly this exclusion)."""
        msg = TxMessage(tx.serialize())
        self._stamp_ctx(msg, txid=tx.txid())
        data = frame(msg)
        with self._peers_lock:
            targets = [
                p
                for p in self.peers.values()
                if not except_ids or p.uid not in except_ids
            ]
        for p in targets:
            p.send(data)

    def peer_count(self) -> int:
        with self._peers_lock:
            return len(self.peers)

    def squelch_json(self) -> dict:
        """`squelch.*` observability block: policy + relay fan-out
        evidence + sendq shedding (live peers' counts folded in)."""
        out = self.squelch.get_json()
        out.update(self.overlay_stats.snapshot())
        with self._peers_lock:
            live_drops = sum(p.sendq_dropped for p in self.peers.values())
        out["sendq_dropped"] += live_drops
        return out

    def peers_json(self) -> list[dict]:
        """reference: OverlayImpl::json / handlers/Peers.cpp row shape."""
        from ..protocol.keys import encode_node_public

        with self._peers_lock:
            peers = list(self.peers.items())
        out = []
        for pub, p in peers:
            out.append(
                {
                    "public_key": encode_node_public(pub),
                    "address": f"{p.addr[0]}:{p.addr[1]}" if p.addr else "",
                    "inbound": bool(p.inbound),
                    "alive": bool(p.alive),
                }
            )
        return out
