"""Device milliseconds per dense-test video of the work launched inside the
program's ``model.stem`` spans (conv1, bn1, ReLU and pool1 of the 3-D
ResNet), from a profiled stretch with spans on. Nothing to read where the
program has no such span or the spans' clock check fails."""


def read(trace):
    return trace.get('stem_device_ms')
