"""Share of the wall time of a test-CLI pass in which no kernel or copy
ran on the device, in percent: 1 - device busy time per video (a profiled
pass) / wall time per video (the unprofiled passes of the same run)."""

from port_bench.lib.readings import idle_share_pct


def read(trace):
    return idle_share_pct(trace, 'cli')
