"""TLS transport for validator peer links.

The reference encrypts EVERY peer connection with anonymous-cipher SSL
and proves node-key ownership by signing material bound to that specific
SSL session (PeerImp.h:88-90 async_handshake over beast MultiSocket; the
TMHello carries a node-key signature over the session fingerprint, so a
terminating man-in-the-middle is detected even though no certificate is
verified).

This package's equivalent, same trust model:

- Each node auto-generates a THROWAWAY self-signed cert (identity lives
  in the node keypair, not the X.509 subject) and peers use
  ``CERT_NONE`` — encryption without PKI, exactly the anonymous-cipher
  semantics.
- Links pin TLS 1.2 so the RFC 5929 ``tls-unique`` channel binding is
  available (CPython exposes no binding for TLS 1.3); the binding is
  mixed into the session hash each side signs with its node key in the
  hello. The binding differs on the two legs of any terminating MITM,
  so the hello signature check fails — the reference's session proof.
- Inbound sockets auto-detect TLS by peeking for the 0x16 handshake
  record (the reference's MultiSocket does the same SSL-or-plain
  autodetection), so a net can be upgraded node by node; ``required``
  refuses plaintext peers outright.
"""

from __future__ import annotations

import datetime
import os
import socket
import ssl
from typing import Optional

__all__ = ["PeerTLS", "ensure_node_cert", "make_door_ssl_context"]


def make_door_ssl_context(
    cert_path: str, key_path: str, state_dir: str
) -> ssl.SSLContext:
    """Server-side TLS context for the API doors (reference
    [rpc_secure]/[websocket_secure], Config.cpp:475-492). Empty paths
    auto-generate the node's self-signed transport cert — operators
    terminating with a real cert point [rpc_ssl_cert]/[rpc_ssl_key] at
    it, exactly the reference's config surface."""
    if not (cert_path and key_path):
        cert_path, key_path = ensure_node_cert(state_dir)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def _openssl_cli_cert(cert_path: str, key_path: str) -> tuple[str, str]:
    """Cert generation without the `cryptography` wheel: the ubiquitous
    openssl(1) binary emits the same throwaway self-signed EC transport
    cert. Only reached when the wheel is absent (see ensure_node_cert)."""
    import shutil
    import subprocess

    if shutil.which("openssl") is None:
        raise RuntimeError(
            "peer/door TLS needs a certificate but neither the "
            "`cryptography` wheel nor "
            "an openssl(1) binary is available"
        )
    # 0o600 on the key from birth: pre-create it and have openssl write
    # into the existing file
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    os.close(fd)
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "ec",
            "-pkeyopt", "ec_paramgen_curve:prime256v1",
            "-keyout", key_path, "-out", cert_path,
            "-days", "3650", "-nodes",
            "-subj", "/CN=stellard-tpu-peer",
        ],
        check=True, capture_output=True,
    )
    return cert_path, key_path


def ensure_node_cert(state_dir: str) -> tuple[str, str]:
    """Return (cert_path, key_path), generating a self-signed EC cert on
    first use. The cert is a transport artifact only — peers never verify
    it — so its subject/lifetime carry no meaning."""
    os.makedirs(state_dir, exist_ok=True)
    cert_path = os.path.join(state_dir, "peer_tls_cert.pem")
    key_path = os.path.join(state_dir, "peer_tls_key.pem")
    if os.path.exists(cert_path) and os.path.exists(key_path):
        return cert_path, key_path

    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError:
        return _openssl_cli_cert(cert_path, key_path)

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "stellard-tpu-peer")]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=3650))
        .sign(key, hashes.SHA256())
    )
    flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
    with os.fdopen(os.open(key_path, flags, 0o600), "wb") as f:
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            )
        )
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    return cert_path, key_path


class PeerTLS:
    """Per-overlay TLS wrapper: one server context (our throwaway cert)
    and one verification-free client context, both pinned to TLS 1.2 for
    the tls-unique session binding."""

    def __init__(self, cert_path: str, key_path: str, required: bool = False):
        self.required = required
        srv = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        srv.load_cert_chain(cert_path, key_path)
        cli = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        cli.check_hostname = False
        for ctx in (srv, cli):
            ctx.verify_mode = ssl.CERT_NONE
            ctx.minimum_version = ssl.TLSVersion.TLSv1_2
            ctx.maximum_version = ssl.TLSVersion.TLSv1_2
        self._server_ctx = srv
        self._client_ctx = cli

    @classmethod
    def from_state_dir(cls, state_dir: str, required: bool = False) -> "PeerTLS":
        cert, key = ensure_node_cert(state_dir)
        return cls(cert, key, required=required)

    def wrap_server(self, sock: socket.socket) -> ssl.SSLSocket:
        return self._server_ctx.wrap_socket(sock, server_side=True)

    def wrap_client(self, sock: socket.socket) -> ssl.SSLSocket:
        return self._client_ctx.wrap_socket(sock)

    @staticmethod
    def is_tls_client_hello(sock: socket.socket, timeout: float = 5.0) -> bool:
        """Peek the first byte without consuming it: 0x16 is the TLS
        handshake record type; anything else is our plaintext nonce
        exchange (reference: MultiSocket's SSL-or-plain autodetect)."""
        prev = sock.gettimeout()
        sock.settimeout(timeout)
        try:
            first = sock.recv(1, socket.MSG_PEEK)
        except OSError:
            return False
        finally:
            sock.settimeout(prev)
        return first == b"\x16"

    @staticmethod
    def channel_binding(sock) -> bytes:
        """RFC 5929 tls-unique of an established TLS session (b"" on a
        plaintext socket) — mixed into the signed session hash so the
        hello proof is bound to THIS encrypted channel."""
        get = getattr(sock, "get_channel_binding", None)
        if get is None:
            return b""
        try:
            return get("tls-unique") or b""
        except (ValueError, ssl.SSLError):
            return b""
