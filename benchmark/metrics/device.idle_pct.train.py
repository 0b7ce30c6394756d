"""Share of the traced stretch of a train window in which no operation ran
on the device (profiler)."""

from benchmark.lib.readers import idle_pct


def read(records):
    return idle_pct(records)
