"""Stream tags: offset-keyed metadata riding alongside sample streams.

Analog of gr_tags.h (gnuradio-core/src/lib/runtime/gr_tags.h): a tag is
(absolute item offset, key, value, source id).  Values are arbitrary Python
objects (the reference uses PMTs; see grtpu.runtime.pmt).

Propagation policy mirrors gr_block_executor.cc:91-156: offsets are scaled by
the block's relative rate when crossing a rate-changing block.  Tags are a
*control-plane* construct here — they live host-side and move at time-block
granularity, never entering the jitted data path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence


@dataclasses.dataclass(frozen=True, order=True)
class Tag:
    offset: int
    key: str = ""
    value: Any = None
    srcid: str = ""


def propagate_tags(tags: Sequence[Tag], relative_rate: float) -> List[Tag]:
    """Scale tag offsets across a rate change (TPP_ALL_TO_ALL semantics)."""
    if relative_rate == 1.0:
        return list(tags)
    return [
        Tag(int(t.offset * relative_rate), t.key, t.value, t.srcid) for t in tags
    ]


def tags_in_window(tags: Sequence[Tag], start: int, end: int) -> List[Tag]:
    """Tags with start <= offset < end (gr_buffer::get_tags_in_range)."""
    return sorted(t for t in tags if start <= t.offset < end)
