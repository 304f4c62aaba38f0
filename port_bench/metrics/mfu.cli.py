"""Model FLOP utilization of the test CLI, in percent of the card's bf16
peak: the reference model's forward FLOPs per video (convolutions and the
FC) x videos / unprofiled wall seconds / 989 TFLOP/s."""

from port_bench.lib.readings import mfu_pct


def read(trace):
    return mfu_pct(trace, 'cli')
