"""The fused eval bottleneck kernel's share of its roofline, in percent:
the sum of its launches' bounds (``lib.peaks``, from the launch shapes the
program's counter recorded) over the sum of their profiler device times.
Nothing to read where the kernel did not launch."""


def read(trace):
    fused = trace.get('fused_bottleneck')
    if not fused or not fused['launches']:
        return None
    return 100.0 * fused['bound_s'] / fused['device_s']
