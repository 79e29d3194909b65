"""Client API: JSON-RPC + WebSocket handlers and servers.

Reference layer L9 (SURVEY §1): src/ripple_rpc (60 handlers),
src/ripple_app/rpc (dispatch), src/ripple/http, src/ripple_app/websocket.
"""

from .errors import RPCError, rpc_error
from .handlers import dispatch, HANDLERS, Role
from .infosub import InfoSub, SubscriptionManager

__all__ = [
    "RPCError",
    "rpc_error",
    "dispatch",
    "HANDLERS",
    "Role",
    "InfoSub",
    "SubscriptionManager",
]
