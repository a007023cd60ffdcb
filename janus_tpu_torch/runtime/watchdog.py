"""Failure detection: loop heartbeats and stall alarms.

The reference's only failure handling was per-stage try/except (SURVEY.md
§5 — no detection, no recovery hooks). This watchdog gives every runtime
loop a heartbeat; a monitor thread raises an alarm callback when a loop
misses its deadline (hung socket, wedged device call, dead thread), which
is what a supervisor needs to restart a session or fail over a host.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["Watchdog", "Heartbeat"]


@dataclass
class Heartbeat:
    name: str
    interval: float                  # expected beat period (seconds)
    grace: float = 3.0               # multiples of interval before alarm
    last_beat: float = field(default_factory=time.monotonic)
    alarmed: bool = False

    def beat(self) -> None:
        self.last_beat = time.monotonic()
        self.alarmed = False

    @property
    def overdue(self) -> bool:
        return time.monotonic() - self.last_beat > self.interval * self.grace


class Watchdog:
    """Registers heartbeats and monitors them from a daemon thread."""

    def __init__(self, on_stall: Optional[Callable[[str, float], None]] = None,
                 poll: float = 0.25) -> None:
        self._beats: Dict[str, Heartbeat] = {}
        self._lock = threading.Lock()
        self._on_stall = on_stall
        self._poll = poll
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stalls: List[str] = []

    def register(self, name: str, interval: float, grace: float = 3.0) -> Heartbeat:
        hb = Heartbeat(name=name, interval=interval, grace=grace)
        with self._lock:
            self._beats[name] = hb
        return hb

    def unregister(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def check(self) -> List[str]:
        """One synchronous sweep; returns names that just went stale."""
        stale = []
        with self._lock:
            beats = list(self._beats.values())
        for hb in beats:
            if hb.overdue and not hb.alarmed:
                hb.alarmed = True
                stale.append(hb.name)
                self.stalls.append(hb.name)
                if self._on_stall is not None:
                    self._on_stall(hb.name, time.monotonic() - hb.last_beat)
        return stale

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                self.check()
                self._stop.wait(self._poll)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="janus-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
