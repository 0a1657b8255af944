"""TopBlock: the gr.top_block-shaped convenience wrapper.

Port of ``grtpu.runtime.top_block``.  Analog of gr_top_block /
gr/top_block.py: owns a Graph, builds the executor on ``start()`` and
exposes the reference's lifecycle verbs (start/stop/wait/run, lock/unlock
and reconfiguration).  There is no scheduler thread: ``start()`` builds the
StreamExecutor and ``run()`` streams chunks through it; lock/unlock rebuild
the executor while the block and halo state survives (the analog of
gr_top_block_impl::restart, gr_top_block_impl.cc:129-180).

Also carries the message plumbing: blocks may register a host-side
``msg_handler`` (gr_basic_block::set_msg_handler analog); ``post_msg()``
queues a message that is dispatched after the next run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from grtpu_torch.runtime.executor import StreamExecutor
from grtpu_torch.runtime.graph import Graph
from grtpu_torch.runtime.msg import Message
from grtpu_torch.utils.device import resolve


class TopBlock(Graph):
    """Graph + lifecycle.  Use exactly like gr.top_block:

        tb = TopBlock()
        tb.connect(src, blk, sink)
        tb.run(steps=...)        # or tb.run(input_arrays)

    ``device`` is where the executor runs: the card unless named.
    """

    def __init__(self, name: str = "top_block", chunk_size: int = 4096,
                 device=None):
        super().__init__(name)
        self.chunk_size = chunk_size
        self.device = resolve(device)
        self.executor: Optional[StreamExecutor] = None
        self._locked = False
        self._msg_handlers: Dict[str, Any] = {}
        self._pending = []

    # ------------------------------------------------------------ lifecycle
    def _build(self) -> StreamExecutor:
        return StreamExecutor(self, chunk_size=self.chunk_size,
                              device=self.device)

    def start(self, chunk_size: Optional[int] = None):
        """Flatten, validate and build the executor (gr_top_block::start
        without the thread spawn)."""
        if chunk_size is not None:
            self.chunk_size = chunk_size
        self.executor = self._build()
        return self

    def run(self, *inputs, steps: Optional[int] = None,
            chunk_size: Optional[int] = None):
        """start(); stream everything; return pad outputs (tb.run analog)."""
        if self.executor is None or chunk_size is not None:
            self.start(chunk_size)
        out = self.executor.run(*inputs, steps=steps)
        self._dispatch_msgs()
        return out

    def stop(self):
        """No threads to interrupt; kept for API parity."""

    def wait(self):
        """No threads to join; kept for API parity."""

    # ----------------------------------------------------- reconfiguration
    def lock(self):
        """Quiesce for live reconfiguration (gr_top_block::lock)."""
        self._locked = True

    def unlock(self):
        """Rebuild the executor, keeping every block and halo state that
        survives the edit (gr_top_block_impl::restart analog)."""
        self._locked = False
        if self.executor is None:
            return
        old_state = self.executor.state
        self.executor = self._build()
        # graft surviving block states by uid
        new_state = self.executor.state
        for uid, st in old_state["blocks"].items():
            if uid in new_state["blocks"]:
                new_state["blocks"][uid] = st
        for k, v in old_state["tails"].items():
            if k in new_state["tails"] and \
                    new_state["tails"][k].shape == v.shape:
                new_state["tails"][k] = v
        self.executor.state = new_state

    # ------------------------------------------------------------ messages
    def set_msg_handler(self, block_name: str, handler):
        """gr_basic_block::set_msg_handler analog (host-side, per run)."""
        self._msg_handlers[block_name] = handler

    def post_msg(self, block_name: str, msg: Message):
        self._pending.append((block_name, msg))

    def _dispatch_msgs(self):
        for name, msg in self._pending:
            h = self._msg_handlers.get(name)
            if h:
                h(msg)
        self._pending = []
