"""RPC error taxonomy.

Reference: src/ripple_rpc (ErrorCodes.h) — errors render as
{error, error_code, error_message} inside a "status":"error" response.
"""

from __future__ import annotations

__all__ = ["RPCError", "rpc_error", "ERRORS"]

# (token, code, default message) — subset of reference ErrorCodes.h
ERRORS = {
    "unknownCmd": (26, "Unknown method."),
    "invalidParams": (27, "Invalid parameters."),
    "actNotFound": (15, "Account not found."),
    "actMalformed": (16, "Account malformed."),
    "lgrNotFound": (20, "Ledger not found."),
    "txnNotFound": (24, "Transaction not found."),
    "badSecret": (41, "Bad secret."),
    "badSeed": (42, "Disallowed seed."),
    "noPermission": (6, "You don't have permission for this command."),
    "notStandalone": (7, "Operation valid in standalone mode only."),
    "srcActMissing": (59, "Source account not provided."),
    "srcActMalformed": (60, "Source account malformed."),
    "dstActMissing": (61, "Destination account not provided."),
    "dstActMalformed": (62, "Destination account malformed."),
    "invalidTransaction": (74, "Transaction is invalid."),
    "internal": (71, "Internal error."),
    "notImpl": (72, "Not implemented."),
    "notSupported": (73, "Operation not supported."),
    "notSynced": (55, "Not synced to the network."),
    "lgrIdxInvalid": (57, "Ledger index below the retained history floor."),
    "transactionNotFound": (24, "Transaction not found."),
    "fieldNotFoundTransaction": (63, "Field 'transaction' not found."),
    # resource pricing on the RPC doors (reference rpcSLOW_DOWN): the
    # client's charge balance crossed the drop line — requests refuse
    # until it decays
    "slowDown": (10, "You are placing too much load on the server."),
}


class RPCError(Exception):
    def __init__(self, token: str, message: str | None = None, **extra):
        code, default_msg = ERRORS.get(token, (71, token))
        self.token = token
        self.code = code
        self.message = message or default_msg
        self.extra = extra
        super().__init__(self.message)

    def to_json(self) -> dict:
        out = {
            "error": self.token,
            "error_code": self.code,
            "error_message": self.message,
        }
        out.update(self.extra)
        return out


def rpc_error(token: str, message: str | None = None, **extra) -> dict:
    return RPCError(token, message, **extra).to_json()
