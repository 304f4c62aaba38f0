"""Device milliseconds per train step that the work launched inside the
program's ``model.se`` spans adds to the busy time (each squeeze-excite's
pool, FCs, gate and scale, forward and backward;
``drivers/x3d_train.py``'s ``busy_ms_within``), from a profiled stretch
with spans on. Nothing to read where the program has no such span or the
spans' clock check fails."""


def read(trace):
    return trace.get('se_device_ms')
