"""Host and device memory tracking and cache management (counterpart of
the JAX package's utils/memory.py; the reference's
memory_cache_utils.py):

- host_memory_mb and SystemMemoryTracker (:13-109): host RAM from
  /proc/meminfo and /proc/self/status, sampled by a background thread;
  device_memory_mb reads each card's allocator (torch.cuda.memory_stats)
  and its free and total memory (torch.cuda.mem_get_info);
- CacheManager (:111-166): bounded LRU caches with explicit purge;
- MemoryManager (:168-307): on pressure, purge the caches, collect
  garbage and return the caching allocator's free blocks to the card
  (torch.cuda.empty_cache), as the reference's handle_oom does.

The host parts are the port's own copies of the JAX package's (each
names the line it was copied from).
"""

from __future__ import annotations

import gc
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional


def host_memory_mb() -> Dict[str, float]:
    """RSS of this process + system available, in MB.

    Copied from video_chapter_generation_tpu/utils/memory.py:23."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_mb"] = float(line.split()[1]) / 1024
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    out["available_mb"] = float(line.split()[1]) / 1024
    except OSError:
        pass
    return out


def device_memory_mb() -> List[Dict[str, float]]:
    """Per card: the caching allocator's bytes in use, reserved and peak
    (torch.cuda.memory_stats) and the card's free and total memory
    (torch.cuda.mem_get_info), in MB; [] where no card is present."""
    import torch

    if not torch.cuda.is_available():
        return []
    stats = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        stats.append({
            "allocated_mb": s.get("allocated_bytes.all.current", 0) / 2**20,
            "reserved_mb": s.get("reserved_bytes.all.current", 0) / 2**20,
            "peak_allocated_mb": s.get("allocated_bytes.all.peak", 0)
            / 2**20,
            "free_mb": free / 2**20,
            "total_mb": total / 2**20,
        })
    return stats


class SystemMemoryTracker:
    """Background sampler with peak tracking and an optional pressure
    callback (fired when host available memory drops below min_free_mb).

    Copied from video_chapter_generation_tpu/utils/memory.py:60."""

    def __init__(self, interval_sec: float = 5.0,
                 min_free_mb: float = 512.0,
                 on_pressure: Optional[Callable[[], None]] = None):
        self.interval = interval_sec
        self.min_free_mb = min_free_mb
        self.on_pressure = on_pressure
        self.peak_rss_mb = 0.0
        self.last: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SystemMemoryTracker":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample()

    def sample(self) -> Dict[str, float]:
        m = host_memory_mb()
        self.last = m
        self.peak_rss_mb = max(self.peak_rss_mb, m.get("rss_mb", 0.0))
        if (
            self.on_pressure is not None
            and m.get("available_mb", float("inf")) < self.min_free_mb
        ):
            self.on_pressure()
        return m

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class CacheManager:
    """Named bounded LRU caches with global purge.

    Copied from video_chapter_generation_tpu/utils/memory.py:101."""

    def __init__(self):
        self._caches: Dict[str, OrderedDict] = {}
        self._limits: Dict[str, int] = {}

    def cache(self, name: str, max_items: int = 1024) -> None:
        self._caches.setdefault(name, OrderedDict())
        self._limits[name] = max_items

    def get(self, name: str, key, factory: Callable[[], Any]):
        c = self._caches[name]
        if key in c:
            c.move_to_end(key)
            return c[key]
        value = factory()
        c[key] = value
        if len(c) > self._limits[name]:
            c.popitem(last=False)
        return value

    def purge(self, name: Optional[str] = None) -> None:
        if name is None:
            for c in self._caches.values():
                c.clear()
        else:
            self._caches[name].clear()

    def sizes(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self._caches.items()}


class MemoryManager:
    """Pressure handling: purge caches, GC and the allocator's cached
    blocks (the reference's handle_oom, memory_cache_utils.py:290-293).

    Copied from video_chapter_generation_tpu/utils/memory.py:134, with
    torch.cuda.empty_cache() in handle_oom."""

    def __init__(self, interval_sec: float = 5.0, min_free_mb: float = 512.0):
        self.cache_manager = CacheManager()
        self.tracker = SystemMemoryTracker(
            interval_sec, min_free_mb, on_pressure=self.handle_oom
        )
        self.oom_events = 0

    def get_cache_manager(self) -> CacheManager:
        return self.cache_manager

    def handle_oom(self) -> None:
        import torch

        self.oom_events += 1
        self.cache_manager.purge()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def status(self) -> Dict:
        return {
            "host": self.tracker.last or host_memory_mb(),
            "peak_rss_mb": self.tracker.peak_rss_mb,
            "caches": self.cache_manager.sizes(),
            "oom_events": self.oom_events,
        }
