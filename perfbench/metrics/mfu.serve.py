"""The model step's share of the card's bf16 peak in the traced window:
FLOPs the prefills K1 ran in the trace and the tokens that
reached the client inside it need, over the device's busy time
times 989 TFLOP/s, in %."""
from perfbench import readers, yardstick


def read(run):
    work = readers.traced_work(run)
    if work is None or work[0] <= 0 or run['trace']['busy_s'] <= 0:
        return None
    return 100.0 * work[0] / (run['trace']['busy_s']
                              * yardstick.PEAK_BF16_FLOPS)
