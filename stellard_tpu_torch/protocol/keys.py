"""Identities: seeds, Ed25519 keypairs, and Base58Check encodings.

Reference semantics (src/ripple_data/protocol/RippleAddress.cpp,
src/ripple_data/crypto/EdKeyPair.cpp, StellarPublicKey.cpp):

- a **seed** is 32 bytes (base58check version 33, renders s...); a
  passphrase maps to a seed via SHA-512-half (EdKeyPair::passPhraseToKey)
- an account/node keypair is the libsodium ``crypto_sign_seed_keypair`` of
  the seed; public keys are raw 32-byte Ed25519 points
- the **account ID** is RIPEMD160(SHA256(pubkey)) (version 0, renders g...)
- signatures are Ed25519 over the 32-byte signing hash, and verification
  additionally enforces the canonical-S rule S < l
  (RippleAddress.cpp:226-252 signatureIsCanonical)
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# `cryptography` is an OPTIONAL accelerator: when the wheel is absent the
# same operations run on the pure-Python RFC 8032 reference
# (ops/ed25519_ref — byte-identical keys and signatures). Nothing in the
# protocol plane may hard-require the wheel.
try:  # pragma: no cover - exercised by whichever env runs the suite
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover
    HAVE_CRYPTOGRAPHY = False

from ..ops.ed25519_ref import key_is_canonical
from ..utils.base58 import b58check_decode, b58check_encode
from ..utils.hashes import hash160, sha512_half

# Base58Check version bytes (reference RippleAddress.h:50-57)
VER_NODE_PUBLIC = 122  # n...
VER_NODE_PRIVATE = 102  # h...
VER_ACCOUNT_ID = 0  # g...
VER_ACCOUNT_PUBLIC = 67  # p...
VER_ACCOUNT_PRIVATE = 101  # h...
VER_SEED = 33  # s...

# Ed25519 group order l = 2^252 + 27742317777372353535851937790883648493;
# the canonical-S rule rejects sigs with S >= l (RippleAddress.cpp:226-252).
ED25519_L = (1 << 252) + 27742317777372353535851937790883648493


def encode_account_id(account_id: bytes) -> str:
    return b58check_encode(VER_ACCOUNT_ID, account_id)


def decode_account_id(s: str) -> bytes:
    _, payload = b58check_decode(s, VER_ACCOUNT_ID)
    if len(payload) != 20:
        raise ValueError("account ID must be 20 bytes")
    return payload


def encode_seed(seed: bytes) -> str:
    return b58check_encode(VER_SEED, seed)


def decode_seed(s: str) -> bytes:
    _, payload = b58check_decode(s, VER_SEED)
    if len(payload) != 32:
        raise ValueError("seed must be 32 bytes")
    return payload


def encode_node_public(pubkey: bytes) -> str:
    return b58check_encode(VER_NODE_PUBLIC, pubkey)


def decode_node_public(s: str) -> bytes:
    _, payload = b58check_decode(s, VER_NODE_PUBLIC)
    return payload


def encode_account_public(pubkey: bytes) -> str:
    return b58check_encode(VER_ACCOUNT_PUBLIC, pubkey)


def decode_account_public(s: str) -> bytes:
    _, payload = b58check_decode(s, VER_ACCOUNT_PUBLIC)
    return payload


def passphrase_to_seed(passphrase: str) -> bytes:
    """SHA-512-half of the passphrase bytes (EdKeyPair::passPhraseToKey)."""
    return sha512_half(passphrase.encode("utf-8"))


def signature_is_canonical(sig: bytes) -> bool:
    if len(sig) != 64:
        return False
    return int.from_bytes(sig[32:], "little") < ED25519_L


# host signature verifications since the last reset: every
# verify_signature call, and every signature of a native host batch
# (crypto.backend.NativeVerifier); a close whose verdicts all came from
# the card leaves this at 0
host_verifies = 0

# -- the no-wheel path (no `cryptography`) -----------------------------------


def _fallback_verify(public: bytes, msg: bytes, sig: bytes) -> bool:
    """Single-signature verify without the `cryptography` wheel: the
    native C++ batch kernel where the host library builds (a batch of
    one), else the pure-Python RFC 8032 oracle."""
    from ..native import Ed25519NativeVerify, load_host

    if load_host() is None:
        from ..ops import ed25519_ref

        return ed25519_ref.verify(public, msg, sig)
    return bool(Ed25519NativeVerify().verify_batch([public], [msg], [sig])[0])


@dataclass(frozen=True)
class KeyPair:
    """Ed25519 seed keypair."""

    seed: bytes
    public: bytes  # 32-byte raw public key

    @classmethod
    def from_seed(cls, seed: bytes) -> "KeyPair":
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        if HAVE_CRYPTOGRAPHY:
            priv = Ed25519PrivateKey.from_private_bytes(seed)
            pub = priv.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw
            )
        else:
            from ..ops.ed25519_ref import derive_public

            pub = derive_public(seed)
        return cls(seed, pub)

    @classmethod
    def from_passphrase(cls, passphrase: str) -> "KeyPair":
        return cls.from_seed(passphrase_to_seed(passphrase))

    @classmethod
    def random(cls) -> "KeyPair":
        return cls.from_seed(os.urandom(32))

    @property
    def account_id(self) -> bytes:
        return hash160(self.public)

    @property
    def human_account_id(self) -> str:
        return encode_account_id(self.account_id)

    @property
    def human_seed(self) -> str:
        return encode_seed(self.seed)

    @property
    def human_account_public(self) -> str:
        return encode_account_public(self.public)

    @property
    def human_node_public(self) -> str:
        return encode_node_public(self.public)

    def sign(self, signing_hash: bytes) -> bytes:
        """Detached Ed25519 signature over the 32-byte signing hash
        (reference RippleAddress::sign -> crypto_sign_detached)."""
        if len(signing_hash) != 32:
            raise ValueError("signing hash must be 32 bytes")
        if HAVE_CRYPTOGRAPHY:
            return Ed25519PrivateKey.from_private_bytes(self.seed).sign(
                signing_hash
            )
        from ..ops.ed25519_ref import sign as ref_sign

        return ref_sign(self.seed, self.public, signing_hash)


def verify_signature(public: bytes, signing_hash: bytes, sig: bytes) -> bool:
    """CPU-path single verification with the canonical-S rule
    (StellarPublicKey::verifySignature) and the canonical key (y < p,
    which the `cryptography` wheel does not check)."""
    global host_verifies
    host_verifies += 1
    if len(public) != 32 or len(sig) != 64 or len(signing_hash) != 32:
        return False
    if not signature_is_canonical(sig) or not key_is_canonical(public):
        return False
    if not HAVE_CRYPTOGRAPHY:
        return _fallback_verify(public, signing_hash, sig)
    try:
        Ed25519PublicKey.from_public_bytes(public).verify(sig, signing_hash)
        return True
    except (InvalidSignature, ValueError):
        return False
