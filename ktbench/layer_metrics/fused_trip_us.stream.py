"""``fused_trip_us`` in the stream cell: device microseconds per inner
trip of the fused level kernel over every launch of the traced process
(the stream's opening decompose, its warm updates, the window and the
stretch)."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_level_device_seconds", "peel_level_trips", scale=1e6)
