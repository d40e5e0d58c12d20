"""K1's share of its roofline in the traced window: the least time the
prefills whose K1 launches the trace holds need in attention (real
prompt lengths, the layers held), over K1's device time in the trace,
in %."""
from perfbench import devtrace, readers


def read(run):
    work = readers.traced_work(run)
    if work is None or not work[2]:
        return None
    k1_s = devtrace.device_seconds(run['trace'], readers.K1_KERNEL)
    if k1_s <= 0:
        return None
    return 100.0 * work[1] / k1_s
