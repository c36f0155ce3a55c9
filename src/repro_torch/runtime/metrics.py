"""Load counters of the PS runtime.

Client processes snapshot their load counters at clock boundaries and
piggyback them on the :class:`~repro_torch.runtime.messages.ClockMsg` they
already send (``ClockMsg.load``); each shard keeps the newest snapshot per
process in ``ServerShard.proc_load``.  The unified ``rt.metrics()`` read
surface is ROADMAP Queue 1 item 5.
"""
# indices of the ClockMsg.load counter vector (one float64 per slot; the
# array is tiny and rides the control message)
LOAD_UPDATES = 0          # Incs applied by this process so far
LOAD_BLOCK_CLOCK = 1      # cumulative seconds blocked in the clock gate
LOAD_BLOCK_VALUE = 2      # cumulative seconds blocked in the value gate
LOAD_LEN = 3
