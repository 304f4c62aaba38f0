"""Model FLOP utilization of the train step, in percent of the card's bf16
peak: the reference model's FLOPs per item (convolutions and the FC,
forward and backward) x items / unprofiled wall seconds / 989 TFLOP/s."""

from port_bench.lib.readings import mfu_pct


def read(trace):
    return mfu_pct(trace, 'train')
