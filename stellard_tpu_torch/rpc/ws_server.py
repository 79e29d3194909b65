"""WebSocket door: RFC 6455 server + command routing + pub/sub delivery.

Reference: src/ripple_app/websocket (WSDoor → WSServerHandler →
WSConnection over vendored websocketpp) — commands are JSON objects
{"command": ..., "id": ...} answered with {"result", "status", "type":
"response", "id"}; the connection doubles as an InfoSub sink receiving
stream messages. The frame layer here is a from-scratch RFC 6455
implementation (text frames, ping/pong, close), since the build vendors
no WebSocket library.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct
import threading
from typing import Optional

from .handlers import Context, Role, dispatch
from .infosub import InfoSub, SubscriptionManager

__all__ = ["WsRpcServer"]

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_MAX_MSG = 4 * 1024 * 1024


def _accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _WS_MAGIC).encode()).digest()
    ).decode()


def _encode_frame(opcode: int, payload: bytes) -> bytes:
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 65536:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


async def _read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes, bool]:
    """-> (opcode, payload, fin)"""
    b1, b2 = await reader.readexactly(2)
    fin = bool(b1 & 0x80)
    opcode = b1 & 0x0F
    masked = bool(b2 & 0x80)
    n = b2 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    if n > _MAX_MSG:
        raise ConnectionError("frame too large")
    mask = await reader.readexactly(4) if masked else b"\x00" * 4
    data = bytearray(await reader.readexactly(n))
    if masked:
        for i in range(len(data)):
            data[i] ^= mask[i & 3]
    return opcode, bytes(data), fin


class WsRpcServer:
    def __init__(self, node, host: str = "127.0.0.1", port: int = 0,
                 subs: Optional[SubscriptionManager] = None,
                 ssl_context=None):
        self._ssl = ssl_context  # reference [websocket_secure] (WSDoor SSL)
        self.node = node
        self.host = host
        self.port = port
        self.subs = subs or SubscriptionManager(node.ops)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._server = None

    # -- connection -------------------------------------------------------

    async def _handshake(self, reader, writer) -> bool:
        header = await reader.readuntil(b"\r\n\r\n")
        lines = header.decode("latin-1").split("\r\n")
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        if not key or "websocket" not in headers.get("upgrade", "").lower():
            writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
            await writer.drain()
            return False
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\n"
            b"Connection: Upgrade\r\n"
            + f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n\r\n".encode()
        )
        await writer.drain()
        return True

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        sub: Optional[InfoSub] = None
        try:
            if not await self._handshake(reader, writer):
                return

            send_lock = asyncio.Lock()
            loop = asyncio.get_running_loop()

            async def send_async(data: bytes) -> None:
                async with send_lock:
                    writer.write(_encode_frame(0x1, data))
                    await writer.drain()

            def send_json_threadsafe(msg: dict) -> None:
                # called from node threads (pub/sub fan-out)
                data = json.dumps(msg).encode()
                asyncio.run_coroutine_threadsafe(send_async(data), loop)

            from .http_server import _role_for_peer

            role = _role_for_peer(self.node, writer)
            peer = writer.get_extra_info("peername")
            client_ip = peer[0] if peer else ""
            # the sub carries its endpoint so per-close path-update
            # shedding/charging (paths/plane.py) keys the same balance
            # as the request door
            sub = InfoSub(send_json_threadsafe, client_ip=client_ip)

            buffer = b""
            while True:
                opcode, payload, fin = await _read_frame(reader)
                if opcode == 0x8:  # close
                    writer.write(_encode_frame(0x8, payload[:2]))
                    await writer.drain()
                    return
                if opcode == 0x9:  # ping
                    writer.write(_encode_frame(0xA, payload))
                    await writer.drain()
                    continue
                if opcode in (0x1, 0x2, 0x0):
                    if len(buffer) + len(payload) > _MAX_MSG:
                        raise ConnectionError("message too large")
                    buffer += payload
                    if not fin:
                        continue
                    message, buffer = buffer, b""
                    resp = await loop.run_in_executor(
                        None, self._process, message, sub, role, client_ip
                    )
                    await send_async(json.dumps(resp).encode())
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            if sub is not None:
                self.subs.remove(sub.id)
            writer.close()

    def _process(self, message: bytes, sub: InfoSub, role: Role,
                 client_ip: str = "") -> dict:
        """reference: WSConnection::invokeCommand — jtCLIENT job body.
        Non-admin commands charge the client's resource balance (same
        FEE_*_RPC schedule as the HTTP door); a client past the drop
        line gets rpcSLOW_DOWN until its balance decays."""
        from .handlers import charge_rpc_client

        try:
            req = json.loads(message)
        except ValueError:
            refused = charge_rpc_client(self.node, client_ip, None, role)
            if refused is not None:
                return {"type": "response", "status": "error",
                        "result": refused}
            return {"type": "error", "error": "jsonInvalid"}
        command = req.get("command")
        if not isinstance(command, str):
            refused = charge_rpc_client(self.node, client_ip, None, role)
            if refused is not None:
                return {"type": "response", "status": "error",
                        "result": refused}
            return {"type": "error", "error": "missingCommand"}
        params = {k: v for k, v in req.items() if k not in ("command", "id")}
        refused = charge_rpc_client(self.node, client_ip, command, role)
        if refused is not None:
            out = {"type": "response", "status": "error", "result": refused}
            if "id" in req:
                out["id"] = req["id"]
            return out
        result = dispatch(
            Context(node=self.node, params=params, role=role,
                    infosub=sub, subs=self.subs),
            command,
        )
        from .handlers import rpc_warning

        warn = rpc_warning(self.node, client_ip, role)
        if warn is not None:
            result["warning"] = warn
        status = "error" if "error" in result else "success"
        out = {"type": "response", "status": status, "result": result}
        if "id" in req:
            out["id"] = req["id"]
        return out

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "WsRpcServer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rpc-ws")
        self._thread.start()
        self._started.wait(timeout=10)
        return self

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port, limit=_MAX_MSG,
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
