"""Proof-of-work anti-DoS challenges.

Role parity with the reference's ProofOfWork plane
(src/ripple_app/misc/ProofOfWork.{h,cpp}:27-120,
ProofOfWorkFactory.cpp): a server hands an untrusted client a
(challenge, iterations, target) tuple; the client searches for a
32-byte solution whose iterated SHA-512-half chain folds to a digest
<= target; verification replays the chain once. The factory binds
challenges to an expiring token so solutions can't be stockpiled.

The chain construction matches the reference exactly (it is a wire-level
behavior): buf2[i] = H(challenge || solution || buf2[i+1]-chain), accept
iff H(buf2[0..n-1]) <= target.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time
from dataclasses import dataclass
from typing import Optional

from .hashes import sha512_half

__all__ = ["ProofOfWork", "PowFactory", "MAX_ITERATIONS", "MIN_TARGET"]

MAX_ITERATIONS = 256
# easiest permissible target (reference sMinTarget): 2^224-ish ceiling
MIN_TARGET = int.from_bytes(
    bytes.fromhex(
        "00000000FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF"
    ),
    "big",
)

# difficulty ladder: (iterations, leading zero bits of target)
_DIFFICULTY = [
    (16, 8),
    (32, 10),
    (64, 12),
    (128, 14),
    (256, 16),
]


def _target_bytes(zero_bits: int) -> bytes:
    t = (1 << (256 - zero_bits)) - 1
    return t.to_bytes(32, "big")


@dataclass(frozen=True)
class ProofOfWork:
    token: str
    iterations: int
    challenge: bytes  # 32 bytes
    target: bytes  # 32 bytes big-endian bound

    def _final_digest(self, solution: bytes) -> bytes:
        link = b"\x00" * 32
        chain: list[bytes] = [b""] * self.iterations
        for i in range(self.iterations - 1, -1, -1):
            link = sha512_half(self.challenge + solution + link)
            chain[i] = link
        return sha512_half(b"".join(chain))

    def check_solution(self, solution: bytes) -> bool:
        if self.iterations > MAX_ITERATIONS or len(solution) != 32:
            return False
        return self._final_digest(solution) <= self.target

    def solve(self, max_attempts: int = 1 << 22) -> Optional[bytes]:
        """Search candidate solutions (reference ProofOfWork::solve walks
        a deterministic candidate sequence; any 32-byte preimage works)."""
        seed = sha512_half(os.urandom(32) + self.challenge)
        for n in range(max_attempts):
            candidate = sha512_half(seed + n.to_bytes(8, "big"))
            if self._final_digest(candidate) <= self.target:
                return candidate
        return None

    @property
    def difficulty(self) -> int:
        """Approximate expected hash count (reference getDifficulty)."""
        t = int.from_bytes(self.target, "big")
        return self.iterations * ((1 << 256) // (t + 1))


class PowFactory:
    """Issues and verifies bound challenges (ProofOfWorkFactory role)."""

    def __init__(self, validity_s: int = 300, difficulty: int = 0):
        self.secret = os.urandom(32)
        self.validity_s = validity_s
        self.difficulty = max(0, min(difficulty, len(_DIFFICULTY) - 1))
        # bucket -> accepted solutions; buckets past expiry are dropped,
        # so replay memory stays bounded by two validity windows
        self._used: dict[int, set[bytes]] = {}

    def _token(self, challenge: bytes, bucket: int) -> str:
        mac = hmac.new(
            self.secret, challenge + bucket.to_bytes(8, "big"), hashlib.sha256
        )
        return f"{bucket}-{mac.hexdigest()[:32]}"

    def get_proof(self, now: Optional[float] = None) -> ProofOfWork:
        bucket = int((now if now is not None else time.time()) // self.validity_s)
        challenge = os.urandom(32)
        iterations, bits = _DIFFICULTY[self.difficulty]
        return ProofOfWork(
            self._token(challenge, bucket),
            iterations,
            challenge,
            _target_bytes(bits),
        )

    def check_proof(
        self, token: str, challenge: bytes, solution: bytes,
        now: Optional[float] = None,
    ) -> tuple[bool, str]:
        """-> (ok, reason). Tokens expire after ~validity and are
        single-use (reference: powCORRUPT / powEXPIRED / powREUSED)."""
        t = now if now is not None else time.time()
        bucket_now = int(t // self.validity_s)
        try:
            bucket = int(token.split("-", 1)[0])
        except (ValueError, IndexError):
            return False, "invalid token"
        if token != self._token(challenge, bucket):
            return False, "invalid token"
        if bucket_now - bucket > 1:
            return False, "expired"
        for stale in [b for b in self._used if bucket_now - b > 1]:
            del self._used[stale]
        if any(solution in s for s in self._used.values()):
            return False, "reused"
        iterations, bits = _DIFFICULTY[self.difficulty]
        pow_ = ProofOfWork(token, iterations, challenge, _target_bytes(bits))
        if not pow_.check_solution(solution):
            return False, "incorrect"
        self._used.setdefault(bucket, set()).add(solution)
        return True, "ok"
