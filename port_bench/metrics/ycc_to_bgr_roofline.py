"""The ``ycc_to_bgr`` kernel's share of its roofline, in percent: the
bound of the frames it converted (``lib.peaks``: planes read once, BGR
written once) over its launches' profiler device time. Nothing to read
where the profiler saw another number of launches than the program's
counter."""


def read(trace):
    ycc = trace.get('ycc_to_bgr')
    if not ycc or not ycc['launches']:
        return None
    return 100.0 * ycc['bound_s'] / ycc['device_s']
