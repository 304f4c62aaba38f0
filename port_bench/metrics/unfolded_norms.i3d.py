"""BatchNorm forwards per dense-test video that no fold took: the growth of
the program's ``BatchNorm.counts['forward']`` over a profiled stretch.
Nothing to read where the program keeps no such counter."""


def read(trace):
    return trace.get('unfolded_norms')
