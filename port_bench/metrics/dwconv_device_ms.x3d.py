"""Device milliseconds per train step that the work launched inside the
program's ``model.dwconv`` spans adds to the busy time (X3D's depthwise
convs, the stem's 5x1x1 and every block's 3x3x3: their forward, and their
data and weight gradients in the backward; ``drivers/x3d_train.py``'s
``busy_ms_within``), from a profiled stretch with spans on. Nothing to
read where the program has no such span or the spans' clock check
fails."""


def read(trace):
    return trace.get('dwconv_device_ms')
