"""Share of the wall time of a dense-test video in which no kernel or copy ran
on the device, in percent: 1 - device busy time per item (the union of
device intervals, profiled stretch) / wall time per item (unprofiled
stretch of the same run)."""

from port_bench.lib.readings import idle_share_pct


def read(trace):
    return idle_share_pct(trace, 'dense')
