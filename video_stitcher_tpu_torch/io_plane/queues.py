"""Bounded frame queue (Python side).

The reference's BlockingQueue (360_stitcher/blockingqueue.h) plus the
call-site policies that live around it: RESULTS_MAX_SIZE caps the results
queue, clear_buffers drops backlog (timed.cpp:141-151, 404-411).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Optional


class FrameQueue:
    def __init__(self, max_size: int = 0, drop_oldest: bool = True):
        self._q: collections.deque = collections.deque()
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self.max_size = max_size
        self.drop_oldest = drop_oldest
        self._closed = False
        #: items lost to the drop-oldest policy (telemetry; the native
        #: FrameQueue keeps the same counter)
        self.dropped = 0

    def push(self, item: Any, block: bool = False) -> bool:
        """block=True waits for space when full (backpressure for the
        staging producer) instead of returning False."""
        with self._cv:
            while (self.max_size and len(self._q) >= self.max_size
                   and not self.drop_oldest and not self._closed):
                if not block:
                    return False
                self._cv.wait(0.1)
            if self._closed:
                return False
            if self.max_size and len(self._q) >= self.max_size:
                self._q.popleft()                  # drop_oldest
                self.dropped += 1
            self._q.append(item)
            self._cv.notify_all()
            return True

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        with self._cv:
            if not self._cv.wait_for(lambda: self._q or self._closed, timeout):
                return None
            if not self._q:
                return None
            item = self._q.popleft()
            self._cv.notify_all()                  # wake blocked pushers
            return item

    def clear(self) -> None:
        with self._cv:
            self._q.clear()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._mu:
            return len(self._q)
