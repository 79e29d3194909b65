"""Overlay plane pieces the node's RPC doors use: the resource charge
schedule and its manager (``resource.py``).

Reference: src/ripple_overlay. The peer transports, wire, consensus relay
and peer discovery are not part of this package.
"""
