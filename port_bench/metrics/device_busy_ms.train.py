"""Device busy milliseconds per train step: the union of kernel and copy
intervals in the profiled stretch over the items it served."""

from port_bench.lib.readings import busy_ms


def read(trace):
    return busy_ms(trace, 'train')
