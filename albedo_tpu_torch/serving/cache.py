"""Hot-user TTL result cache with explicit invalidation.

Host-only copy of ``albedo_tpu/serving/cache.py`` for the PyTorch port.

The reference leans on Django's per-view caching plus MySQL read replicas
for hot users; here a small in-process cache sits in front of the serving
engine: repeated requests for the same (user, k, flags) inside the TTL are
answered without touching the device, and a star-ingest (or test) can
invalidate a user — or everything — explicitly.

LRU + TTL: entries expire ``ttl`` seconds after WRITE (results don't get
fresher by being read), capacity evicts least-recently-used. ``clock`` is
injectable so tests drive expiry deterministically instead of sleeping.

Generation interaction: cached bodies carry the model generation that
computed them, the service's cache key includes the generation number, and
``promote()`` flushes the cache outright — a swapped process can never
answer from the displaced model's results.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Hashable


class TTLCache:
    def __init__(
        self,
        maxsize: int = 4096,
        ttl: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.maxsize = max(1, int(maxsize))
        self.ttl = float(ttl)
        self.clock = clock
        # key -> (expires_at, user_id, value); OrderedDict end = most recent.
        self._data: "OrderedDict[Hashable, tuple[float, Any, Any]]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: Hashable, default: Any = None) -> Any:
        now = self.clock()
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return default
            expires_at, _user, value = entry
            if now >= expires_at:
                del self._data[key]
                return default
            self._data.move_to_end(key)
            return value

    def put(self, key: Hashable, value: Any, user_id: Any = None) -> None:
        """Store ``value``; ``user_id`` tags the entry for targeted
        invalidation (``invalidate_user``)."""
        with self._lock:
            self._data[key] = (self.clock() + self.ttl, user_id, value)
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def invalidate_user(self, user_id: Any) -> int:
        """Drop every entry tagged with ``user_id``; returns how many."""
        with self._lock:
            stale = [k for k, (_e, u, _v) in self._data.items() if u == user_id]
            for k in stale:
                del self._data[k]
            return len(stale)

    def invalidate_all(self) -> int:
        with self._lock:
            n = len(self._data)
            self._data.clear()
            return n

    def __len__(self) -> int:
        """Live entries only — expired-but-unevicted entries don't count."""
        now = self.clock()
        with self._lock:
            return sum(1 for (e, _u, _v) in self._data.values() if now < e)

    def stats(self) -> dict:
        """Live/total entry counts for the readiness report."""
        now = self.clock()
        with self._lock:
            total = len(self._data)
            live = sum(1 for (e, _u, _v) in self._data.values() if now < e)
        return {"live_entries": live, "total_entries": total, "maxsize": self.maxsize}
