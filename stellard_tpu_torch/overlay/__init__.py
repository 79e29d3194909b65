"""Overlay plane: the resource charge schedule and its manager
(``resource.py``, also the RPC doors' pricing), the wire codec
(``proto.py``, ``wire.py``: the same frames as the JAX package, byte for
byte), validator-message squelching (``squelch.py``), the follower tree
plan (``followertree.py``), and the two transports that drive identical
node logic (``node.validator.ValidatorNode``):

- ``simnet`` — the deterministic in-process validator network that
  drives consensus with real wire frames (reference: testoverlay);
- ``tcp`` — length-prefixed frames over real sockets for a validator
  private net (reference: PeerImp framing), with peer discovery
  (``peerfinder.py``) and the peer links' TLS (``peertls.py``).

Reference: src/ripple_overlay.
"""

from .peerfinder import Bootcache, Livecache, PeerFinder
from .peertls import PeerTLS, ensure_node_cert, make_door_ssl_context
from .simnet import SimNet, SimValidator
from .tcp import DeviceFailed, TcpOverlay
from .wire import MessageType, decode_message, encode_message

__all__ = [
    "Bootcache",
    "DeviceFailed",
    "Livecache",
    "MessageType",
    "PeerFinder",
    "PeerTLS",
    "SimNet",
    "SimValidator",
    "TcpOverlay",
    "decode_message",
    "encode_message",
    "ensure_node_cert",
    "make_door_ssl_context",
]
