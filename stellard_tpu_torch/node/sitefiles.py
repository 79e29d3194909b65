"""Validator source files: local validators.txt and hosted stellar.txt.

Role parity with the reference's validator sourcing
(src/ripple_app/peers/UniqueNodeList.cpp nodeBootstrap /
validators.txt handling, src/ripple/sitefiles + ripple_net HTTPClient):
the trusted-validator set can come from
- the inline `[validators]` config section (already wired),
- a local validators file (`[validators_file]`),
- a hosted site file fetched over HTTP (`stellar.txt` with a
  `[validators]` section).

The fetcher is stdlib urllib (the reference's async HTTPS fetcher role);
zero-egress deployments simply configure no sites.
"""

from __future__ import annotations

import urllib.request
from typing import Optional

__all__ = ["parse_validators_text", "load_validators_file", "fetch_site_validators"]


def parse_validators_text(text: str) -> list[tuple[str, str]]:
    """-> [(node_public, comment)]. Accepts both a bare list of keys and
    the sectioned stellar.txt shape (keys read from [validators] /
    [validation_public_key] sections)."""
    out: list[tuple[str, str]] = []
    section: Optional[str] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1].lower()
            continue
        if section not in (None, "validators", "validation_public_key"):
            continue
        parts = line.split(None, 1)
        key = parts[0]
        comment = parts[1] if len(parts) > 1 else ""
        out.append((key, comment))
    return out


def load_validators_file(path: str) -> list[tuple[str, str]]:
    """reference: [validators_file] / validators.txt bootstrap."""
    with open(path) as fh:
        return parse_validators_text(fh.read())


def fetch_site_validators(
    url: str, timeout: float = 5.0
) -> list[tuple[str, str]]:
    """Fetch and parse a hosted stellar.txt (reference: SiteFiles::Manager
    + HTTPClient over HTTPS). Raises OSError on network failure; callers
    decide whether a source being down is fatal (the reference logs and
    moves on).

    The validator list is a TRUST ROOT: plain http is refused except to
    loopback (test harnesses), or an on-path attacker could inject
    validator keys.
    """
    from urllib.parse import urlparse

    parsed = urlparse(url)
    if parsed.scheme != "https" and parsed.hostname not in (
        "localhost", "127.0.0.1", "::1",
    ):
        raise ValueError(
            f"validators_site must be https (got {parsed.scheme!r})"
        )
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return parse_validators_text(resp.read().decode("utf-8", "replace"))
