"""Device microseconds per inner trip of the fused level kernel: the
launches' time between the program's CUDA events
(``peel_level_device_seconds``) over their inner trips
(``peel_level_trips``), over the whole traced process.  The program
counts device seconds only on the card."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_level_device_seconds", "peel_level_trips", scale=1e6)
