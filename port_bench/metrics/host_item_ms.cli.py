"""Mean wall milliseconds of one ``dataset.__getitem__`` on the loader
threads in the unprofiled passes: sampling, nvJPEG decode, resize, crops
and collation of one video, as a thin wrapper around the dataset times
it."""


def read(trace):
    return trace.get('host_item_ms')
