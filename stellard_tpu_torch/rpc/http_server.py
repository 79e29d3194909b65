"""HTTP JSON-RPC door.

Reference: src/ripple/http (async HTTP server framework) bound to the RPC
handler table by RPCHTTPServer (Application.cpp:325); request format is
JSON-RPC 1.0-style {"method": ..., "params": [{...}]} and responses wrap
the handler result as {"result": {..., "status": "success"|"error"}}
(reference: RPCServerHandler::processRequest).

asyncio protocol implementation — no external HTTP library.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Optional

from .errors import RPCError
from .handlers import Context, Role, dispatch

__all__ = ["HttpRpcServer", "process_http_request"]

_MAX_BODY = 10 * 1024 * 1024


def process_http_request(node, body: bytes, role: Role = Role.ADMIN,
                         client_ip: str = "") -> dict:
    """Decode one JSON-RPC request body → response object. Non-admin
    requests charge the client's resource balance (FEE_*_RPC schedule);
    a client past the drop line gets rpcSLOW_DOWN until it decays."""
    from .handlers import charge_rpc_client

    try:
        req = json.loads(body)
    except ValueError:
        refused = charge_rpc_client(node, client_ip, None, role)  # charged
        err = refused or RPCError("invalidParams", "malformed JSON").to_json()
        return {"result": err | {"status": "error"}}
    method = req.get("method")
    params_list = req.get("params") or [{}]
    params = params_list[0] if isinstance(params_list, list) and params_list else {}
    if not isinstance(params, dict):
        params = {}
    if not isinstance(method, str):
        refused = charge_rpc_client(node, client_ip, None, role)
        err = refused or RPCError("unknownCmd").to_json()
        return {"result": err | {"status": "error"}}
    refused = charge_rpc_client(node, client_ip, method, role)
    if refused is not None:
        result = refused | {"status": "error"}
        out = {"result": result}
        if "id" in req:
            out["id"] = req["id"]
        return out
    result = dispatch(Context(node=node, params=params, role=role), method)
    result["status"] = "error" if "error" in result else "success"
    from .handlers import rpc_warning

    warn = rpc_warning(node, client_ip, role)
    if warn is not None:
        result["warning"] = warn
    out = {"result": result}
    if "id" in req:
        out["id"] = req["id"]
    return out


def _role_for_peer(node, writer) -> Role:
    """ADMIN only for connections from [rpc_admin_allow] source IPs
    (reference: RPCHandler role gating by admin-allowed IP)."""
    peer = writer.get_extra_info("peername")
    ip = peer[0] if peer else ""
    return Role.ADMIN if ip in node.config.admin_ips else Role.GUEST


class HttpRpcServer:
    """Minimal threaded asyncio HTTP/1.1 server for the RPC door."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None):
        self._ssl = ssl_context  # reference [rpc_secure] (RPCDoor SSL)
        self.node = node
        self.host = host
        self.port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._server = None

    # -- protocol ---------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                header = await reader.readuntil(b"\r\n\r\n")
                lines = header.decode("latin-1").split("\r\n")
                request_line = lines[0]
                headers = {}
                for line in lines[1:]:
                    if ":" in line:
                        k, v = line.split(":", 1)
                        headers[k.strip().lower()] = v.strip()
                length = int(headers.get("content-length", 0))
                if length > _MAX_BODY:
                    writer.write(b"HTTP/1.1 413 Payload Too Large\r\n\r\n")
                    await writer.drain()
                    return
                body = await reader.readexactly(length) if length else b""
                status_line = b"HTTP/1.1 200 OK\r\n"
                ctype = b"Content-Type: application/json\r\n"
                if request_line.startswith("GET"):
                    path = (
                        request_line.split(" ", 2)[1]
                        if " " in request_line else "/"
                    )
                    if path.split("?", 1)[0] == "/metrics":
                        # Prometheus exposition door (text format 0.0.4,
                        # node/metrics.py prometheus_text). Resource-
                        # priced like any other RPC: a scraper hammering
                        # the door charges its client balance and gets
                        # 429 until it decays (admin IPs exempt).
                        from .handlers import charge_rpc_client

                        peer = writer.get_extra_info("peername")
                        refused = charge_rpc_client(
                            self.node, peer[0] if peer else "",
                            "metrics", _role_for_peer(self.node, writer),
                        )
                        if refused is not None:
                            status_line = (
                                b"HTTP/1.1 429 Too Many Requests\r\n"
                            )
                            payload = b"slow down\n"
                            ctype = b"Content-Type: text/plain\r\n"
                        else:
                            payload = self._metrics_payload()
                            ctype = (
                                b"Content-Type: text/plain; "
                                b"version=0.0.4; charset=utf-8\r\n"
                            )
                    else:
                        payload = b'{"status": "ok"}'
                else:
                    peer = writer.get_extra_info("peername")
                    payload = json.dumps(
                        process_http_request(
                            self.node, body,
                            _role_for_peer(self.node, writer),
                            client_ip=peer[0] if peer else "",
                        )
                    ).encode()
                writer.write(
                    status_line + ctype
                    + f"Content-Length: {len(payload)}\r\n".encode()
                    + b"Connection: keep-alive\r\n\r\n"
                    + payload
                )
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass
        finally:
            writer.close()

    def _metrics_payload(self) -> bytes:
        """One /metrics scrape: every collector instrument (the health
        verdict's gauge is not part of this build: no health watchdog)."""
        try:
            text = self.node.collector.prometheus_text(extra_gauges={})
        except Exception:  # noqa: BLE001 — a scrape must not kill the door
            text = ""
        return text.encode("utf-8")

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "HttpRpcServer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rpc-http")
        self._thread.start()
        self._started.wait(timeout=10)
        return self

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port, limit=_MAX_BODY,
                ssl=self._ssl,
            )
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()

        self._loop.run_until_complete(boot())
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def stop(self) -> None:
        if self._loop and self._loop.is_running():
            def _shutdown():
                if self._server:
                    self._server.close()
                self._loop.stop()

            self._loop.call_soon_threadsafe(_shutdown)
        if self._thread:
            self._thread.join(timeout=5)
