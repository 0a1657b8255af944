"""Message <-> stream bridges.

Port of ``grtpu.io.msgio`` (host only).

Analogs: gr_message_source / gr_message_sink (gnuradio-core/src/lib/io):
the packet-framework bridge between the async MsgQueue world and sample
streams (used by pkt.py's mod_pkts/demod_pkts, SURVEY.md §3.4).

Here the bridge lives at the host chunk loop: MessageSource drains a
MsgQueue into the next chunk's samples; MessageStreamSink cuts the captured
stream back into messages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from grtpu_torch.runtime.msg import Message, MsgQueue


class MessageSource:
    """Drain a MsgQueue into a contiguous sample stream (host-side).

    ``fill(n)`` returns exactly n items, zero-padded when the queue runs
    dry (the reference blocks instead; chunked execution prefers padding +
    an items-consumed count)."""

    def __init__(self, dtype=np.uint8, msgq: Optional[MsgQueue] = None):
        self.dtype = np.dtype(dtype)
        self.msgq = msgq or MsgQueue()
        self._residual = np.zeros(0, self.dtype)
        self.eof = False

    def fill(self, n: int) -> np.ndarray:
        parts = [self._residual]
        have = len(self._residual)
        while have < n:
            msg = self.msgq.delete_head_nowait()
            if msg is None:
                break
            if msg.kind == 1:  # EOF convention
                self.eof = True
                break
            arr = np.frombuffer(msg.to_string(), self.dtype)
            parts.append(arr)
            have += len(arr)
        buf = np.concatenate(parts) if len(parts) > 1 else parts[0]
        if len(buf) >= n:
            self._residual = buf[n:]
            return buf[:n]
        self._residual = np.zeros(0, self.dtype)
        return np.concatenate([buf, np.zeros(n - len(buf), self.dtype)])


class MessageStreamSink:
    """Aggregate stream chunks into fixed-size messages posted to a queue
    (gr_message_sink with itemsize framing)."""

    def __init__(self, items_per_msg: int, dtype=np.uint8,
                 msgq: Optional[MsgQueue] = None):
        self.n = items_per_msg
        self.dtype = np.dtype(dtype)
        self.msgq = msgq or MsgQueue()
        self._buf = np.zeros(0, self.dtype)

    def push(self, chunk: np.ndarray):
        self._buf = np.concatenate([self._buf, np.asarray(chunk, self.dtype)])
        while len(self._buf) >= self.n:
            payload = self._buf[: self.n]
            self._buf = self._buf[self.n:]
            self.msgq.insert_tail(Message(payload=payload.tobytes()))
