"""TaggedCache / KeyCache: expiring keyed caches with sweep.

Role parity with /root/reference/src/ripple/common/TaggedCache.h and
KeyCache.h (tuned at Application.cpp:723-727, swept on the sweep timer):
bounded, aged caches in front of the NodeStore and ledger history so hot
fetch paths stop re-walking storage. The reference splits "cached with
value" (TaggedCache) from "presence only" (KeyCache); both shapes live
here.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Generic, Hashable, Optional, TypeVar

__all__ = ["TaggedCache", "KeyCache"]

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class TaggedCache(Generic[K, V]):
    """LRU + age-bounded value cache (TaggedCache.h role)."""

    def __init__(
        self,
        name: str,
        target_size: int = 1024,
        expiration_s: float = 120.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.name = name
        self.target_size = target_size
        self.expiration_s = expiration_s
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._data: OrderedDict[K, tuple[float, V]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self.misses += 1
                return None
            at, value = entry
            now = self._clock()
            if now - at > self.expiration_s:
                del self._data[key]
                self.misses += 1
                return None
            # age by LAST ACCESS (reference TaggedCache): continuously
            # used entries never expire
            self._data[key] = (now, value)
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: K, value: V) -> None:
        with self._lock:
            self._data[key] = (self._clock(), value)
            self._data.move_to_end(key)
            while len(self._data) > self.target_size:
                self._data.popitem(last=False)

    def fetch(self, key: K, loader: Callable[[], Optional[V]]) -> Optional[V]:
        """get() or load-and-cache (the canonical fetch path shape)."""
        value = self.get(key)
        if value is not None:
            return value
        value = loader()
        if value is not None:
            self.put(key, value)
        return value

    def sweep(self) -> int:
        """Drop expired entries (reference: doSweep timer). Returns the
        number removed."""
        now = self._clock()
        with self._lock:
            dead = [
                k
                for k, (at, _v) in self._data.items()
                if now - at > self.expiration_s
            ]
            for k in dead:
                del self._data[k]
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get_json(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "size": len(self._data),
                "target": self.target_size,
                "hits": self.hits,
                "misses": self.misses,
            }


class KeyCache(Generic[K]):
    """Presence-only cache (KeyCache.h / FullBelowCache role): remembers
    that a key was seen recently, e.g. 'this subtree is fully present
    below' so sync walks skip it."""

    def __init__(
        self,
        name: str,
        target_size: int = 65536,
        expiration_s: float = 120.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._cache: TaggedCache[K, bool] = TaggedCache(
            name, target_size, expiration_s, clock
        )

    def insert(self, key: K) -> None:
        self._cache.put(key, True)

    def __contains__(self, key: K) -> bool:
        return self._cache.get(key) is not None

    def sweep(self) -> int:
        return self._cache.sweep()

    def __len__(self) -> int:
        return len(self._cache)

    def get_json(self) -> dict:
        return self._cache.get_json()
