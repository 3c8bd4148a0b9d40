"""Allocation tracking / leak accounting.

Analog of the reference's ``TRACK_TOKEN_ALLOCATIONS`` debug machinery
(src/TC/src/MemoryInterfaces.cpp:28-127): every Surface/HostBuffer gets an
id; ``check_allocation_counters()`` reports anything still alive. Enabled
with env ``VPF_TPU_TRACK_ALLOCATIONS=1`` (the same switch as the JAX
package) or :func:`enable`.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

_lock = threading.Lock()
_enabled = os.environ.get("VPF_TPU_TRACK_ALLOCATIONS", "0") not in ("0", "")
_next_id = 1
_live: Dict[int, Tuple[str, int]] = {}


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def is_enabled() -> bool:
    return _enabled


def register(kind: str, nbytes: int) -> Optional[int]:
    global _next_id
    if not _enabled:
        return None
    with _lock:
        aid = _next_id
        _next_id += 1
        _live[aid] = (kind, nbytes)
    return aid


def unregister(aid: Optional[int]) -> None:
    if aid is None:
        return
    with _lock:
        _live.pop(aid, None)


def live_allocations() -> Dict[int, Tuple[str, int]]:
    with _lock:
        return dict(_live)


def check_allocation_counters() -> int:
    """Return the number of live tracked allocations; print any leaks."""
    leaks = live_allocations()
    for aid, (kind, nbytes) in sorted(leaks.items()):
        print(f"Leaked {kind} id={aid} ({nbytes} bytes)")
    return len(leaks)


def reset() -> None:
    global _next_id
    with _lock:
        _live.clear()
        _next_id = 1
