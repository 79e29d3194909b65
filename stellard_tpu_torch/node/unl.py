"""UniqueNodeList: the managed trusted-validator registry.

Role parity with the reference's UNL plane
(src/ripple_app/peers/UniqueNodeList.cpp, 2.1k LoC, plus
src/ripple/validators/): the UNL seeds from config `[validators]`,
supports runtime add/remove with comments, persists across restarts
(wallet.db role — a JSON-lines file here), and keeps per-validator
bookkeeping from received validations (the modern replacement for the
deprecated scoring crawler: observed validation counts + last-seen
times, which `unl_score`/`unl_list` report).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterable, Optional

from ..protocol.keys import decode_node_public, encode_node_public

__all__ = ["UniqueNodeList"]


class UniqueNodeList:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        # pubkey -> {"comment": str, "added_at": float}
        self._nodes: dict[bytes, dict] = {}
        # received-validation bookkeeping (validators/ Manager role)
        self._seen: dict[bytes, dict] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    for line in f:
                        rec = json.loads(line)
                        self._nodes[decode_node_public(rec["public"])] = {
                            "comment": rec.get("comment", ""),
                            "added_at": rec.get("added_at", 0.0),
                        }
            except (OSError, ValueError, KeyError):
                self._nodes = {}

    # -- membership -------------------------------------------------------

    def add(self, public: bytes, comment: str = "") -> bool:
        with self._lock:
            if public in self._nodes:
                return False
            self._nodes[public] = {"comment": comment, "added_at": time.time()}
        self.save()
        return True

    def remove(self, public: bytes) -> bool:
        with self._lock:
            if public not in self._nodes:
                return False
            del self._nodes[public]
        self.save()
        return True

    def reset(self) -> None:
        with self._lock:
            self._nodes.clear()
        self.save()

    def load_from(self, publics: Iterable[bytes], comment: str = "config") -> int:
        n = 0
        for pk in publics:
            if self.add(pk, comment):
                n += 1
        return n

    def __contains__(self, public: bytes) -> bool:
        with self._lock:
            return public in self._nodes

    def publics(self) -> set[bytes]:
        with self._lock:
            return set(self._nodes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    # -- validation bookkeeping ------------------------------------------

    def on_validation(self, public: bytes, ledger_seq: Optional[int]) -> None:
        with self._lock:
            rec = self._seen.setdefault(
                public, {"validations": 0, "last_seq": 0, "last_seen": 0.0}
            )
            rec["validations"] += 1
            if ledger_seq:
                rec["last_seq"] = max(rec["last_seq"], ledger_seq)
            rec["last_seen"] = time.time()

    def on_byzantine(self, public: bytes, kind: str) -> None:
        """Per-validator misbehavior bookkeeping: recognized hostile
        inputs attributable to a SIGNING key (equivocating proposals,
        conflicting validations, bad signatures claiming this key).
        Reported by `unl_list`/`unl_score` so an operator can see WHICH
        trusted validator is misbehaving, not just that one is."""
        with self._lock:
            rec = self._seen.setdefault(
                public, {"validations": 0, "last_seq": 0, "last_seen": 0.0}
            )
            byz = rec.setdefault("byzantine", {})
            byz[kind] = byz.get(kind, 0) + 1

    # -- persistence ------------------------------------------------------

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            items = list(self._nodes.items())
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for pk, meta in items:
                f.write(json.dumps({
                    "public": encode_node_public(pk),
                    "comment": meta["comment"],
                    "added_at": meta["added_at"],
                }))
                f.write("\n")
        os.replace(tmp, self.path)

    # -- reporting --------------------------------------------------------

    def get_json(self) -> list[dict]:
        with self._lock:
            out = []
            for pk, meta in sorted(self._nodes.items()):
                seen = self._seen.get(pk, {})
                out.append({
                    "pubkey_validator": encode_node_public(pk),
                    "comment": meta["comment"],
                    "trusted": True,
                    "validations": seen.get("validations", 0),
                    "last_ledger_seq": seen.get("last_seq", 0),
                    "byzantine_events": dict(seen.get("byzantine", {})),
                })
            return out
