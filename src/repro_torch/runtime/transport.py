"""Transport helpers of the PS runtime, in their in-process queue form.

This slice of the port runs the ``queue`` transport only: every channel is
an in-process FIFO :class:`~repro_torch.runtime.messages.Channel`, and every
message owns its arrays.  The wire backends (shm rings with zero-copy views,
loopback tcp) are ROADMAP Queue 1 item 2.  The shard and the client comm
loop already call :func:`materialize_msg` / :func:`release_msgs` where the
wire backends need them; on queue channels both have nothing to do.
"""
from __future__ import annotations

from typing import Dict, Optional


class FifoAssert:
    """Per-sender contiguous-sequence assertion (shared by shard & client).

    ``check(sender, seq)`` returns an error string on a gap/reorder/replay,
    else None.  Mirrors the simulator's ``_last_seq_seen`` checking.
    """

    def __init__(self):
        self._last: Dict[object, int] = {}

    def check(self, sender, seq: int) -> Optional[str]:
        last = self._last.get(sender, -1)
        self._last[sender] = max(seq, last)
        if seq != last + 1:
            return f"seq {seq} after {last}"
        return None


def materialize_msg(msg):
    """Make ``msg`` own its arrays before it is retained past the apply
    cycle that received it.  Queue-channel messages already do."""
    return msg


def release_msgs(msgs) -> None:
    """Drop the messages' pins on their source frames.  Queue-channel
    messages hold none."""
