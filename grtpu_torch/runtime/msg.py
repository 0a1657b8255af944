"""Async message passing between blocks and applications.

grtpu_torch's copy of ``grtpu.runtime.msg`` (numpy only).  Analog of gruel
message passing (gruel/src/include/gruel/msg_queue.h, msg_accepter.h,
msg_passing.h:47-52) and the legacy gr_msg_queue/gr_message
(gnuradio-core/src/lib/runtime/gr_msg_queue.{h,cc}, gr_message.h:39-174 —
note the dmr fork adds a typed header to gr_message, mirrored here as the
``kind``/``arg1``/``arg2`` fields of :class:`Message`).

Messages are control-plane: they move between host-side components (packet
framers, probes, application callbacks) at time-block granularity, never
inside the data path on the device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Optional

import numpy as np


@dataclasses.dataclass
class Message:
    """A typed message (gr_message.h:39-174 with the fork's typed header)."""

    payload: Any = None
    kind: int = 0  # fork's d_type field
    arg1: float = 0.0
    arg2: float = 0.0

    def length(self) -> int:
        if isinstance(self.payload, (bytes, bytearray)):
            return len(self.payload)
        if isinstance(self.payload, np.ndarray):
            return self.payload.nbytes
        return 0

    def to_string(self) -> bytes:
        if isinstance(self.payload, (bytes, bytearray)):
            return bytes(self.payload)
        if isinstance(self.payload, np.ndarray):
            return self.payload.tobytes()
        raise TypeError("payload is not byte-like")


def message_from_string(s: bytes, kind: int = 0, arg1: float = 0.0, arg2: float = 0.0):
    return Message(payload=bytes(s), kind=kind, arg1=arg1, arg2=arg2)


class MsgQueue:
    """Bounded blocking message queue (gr_msg_queue semantics).

    ``insert_tail`` blocks when full (if a limit is set); ``delete_head``
    blocks when empty; ``delete_head_nowait`` returns None instead.
    """

    def __init__(self, limit: int = 0):
        self._q: "queue.Queue[Message]" = queue.Queue(maxsize=limit)

    def insert_tail(self, msg: Message):
        self._q.put(msg)

    def delete_head(self, timeout: Optional[float] = None) -> Message:
        return self._q.get(timeout=timeout)

    def delete_head_nowait(self) -> Optional[Message]:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def empty_p(self) -> bool:
        return self._q.empty()

    def full_p(self) -> bool:
        return self._q.full()

    def count(self) -> int:
        return self._q.qsize()

    def flush(self):
        while self.delete_head_nowait() is not None:
            pass


class MsgAccepter:
    """Callable message sink (gruel::msg_accepter)."""

    def post(self, msg: Message):
        raise NotImplementedError


class MsgAccepterMsgQ(MsgAccepter):
    def __init__(self, msgq: MsgQueue):
        self.msgq = msgq

    def post(self, msg: Message):
        self.msgq.insert_tail(msg)


def send(accepter: MsgAccepter, msg: Message):
    """gruel::send (msg_passing.h:47-52)."""
    accepter.post(msg)


class QueueWatcher:
    """Daemon thread draining a MsgQueue into a callback.

    Analog of the python watcher thread in gr-digital/python/pkt.py:104-128
    (_queue_watcher_thread feeding the rx callback).
    """

    def __init__(self, msgq: MsgQueue, callback: Callable[[Message], None]):
        self.msgq = msgq
        self.callback = callback
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                msg = self.msgq.delete_head(timeout=0.1)
            except queue.Empty:
                continue
            self.callback(msg)

    def stop(self, timeout: Optional[float] = 10.0):
        """Stop the thread and join it, waiting at most ``timeout`` seconds
        (the callback may be running when the stop is asked)."""
        self._stop.set()
        self.thread.join(timeout)
