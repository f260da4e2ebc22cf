"""Logging (port of ``heatray_tpu.utils.log``): the reference's pluggable
``Log`` singleton (``Source/Utility/Log.{h,cpp}``: kInfo/kWarning/kError and
sinks) on stdlib ``logging`` under the ``heatray_tpu_torch`` namespace.  The
ring-buffer handler keeps the last records per severity, as the reference's
in-app console does (``Utility/ImGuiLog.h:20-53``).
"""

from __future__ import annotations

import collections
import logging
from typing import Deque, Dict, List, Tuple

_ROOT = "heatray_tpu_torch"


def get_logger(name: str = "") -> logging.Logger:
    """Namespaced logger (``get_logger("interactive")`` etc.)."""
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


class RingBufferHandler(logging.Handler):
    """Keeps the last ``capacity`` formatted records per severity."""

    def __init__(self, capacity: int = 1000):
        super().__init__()
        self.capacity = capacity
        self.buffers: Dict[str, Deque[str]] = collections.defaultdict(
            lambda: collections.deque(maxlen=capacity)
        )

    def emit(self, record: logging.LogRecord) -> None:
        self.buffers[record.levelname].append(self.format(record))

    def lines(self, level: str | None = None) -> List[str]:
        if level is not None:
            return list(self.buffers[level])
        out: List[Tuple[str, str]] = []
        for lvl, buf in self.buffers.items():
            out.extend((lvl, line) for line in buf)
        return [f"[{lvl}] {line}" for lvl, line in out]

    def dump(self, path: str) -> None:
        """Write every buffered line to ``path`` (the console dump)."""
        with open(path, "w") as f:
            f.write("\n".join(self.lines()) + "\n")


def install_ring_buffer_handler(capacity: int = 1000) -> RingBufferHandler:
    handler = RingBufferHandler(capacity)
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s: %(message)s"))
    get_logger().addHandler(handler)
    return handler
