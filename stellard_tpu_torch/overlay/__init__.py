"""Overlay plane: the resource charge schedule and its manager
(``resource.py``, also the RPC doors' pricing), the wire codec
(``proto.py``, ``wire.py``: the same frames as the JAX package, byte for
byte), validator-message squelching (``squelch.py``), the follower tree
plan (``followertree.py``) and the deterministic in-process validator
network (``simnet.py``) that drives consensus with real wire frames.

Reference: src/ripple_overlay. The TCP peer transport, its TLS and peer
discovery are not part of this package yet.
"""
