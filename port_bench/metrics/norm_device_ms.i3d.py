"""Device milliseconds per dense-test video of the work launched inside the
program's ``model.norm`` spans (each forward of a BatchNorm that no fold
took: its fp32 copy, the norm and the cast back), from a profiled stretch
with spans on. Nothing to read where the program has no such span or the
spans' clock check fails."""


def read(trace):
    return trace.get('norm_device_ms')
