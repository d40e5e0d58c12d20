"""K2's share of its roofline over the traced steps: the least time
their attention backward needs (every layer, causal), over the device
time of K2's kernels (``flash_bwd_``), in %."""
from perfbench import devtrace, yardstick


def read(run):
    tr = run.get('trace')
    if run['kind'] != 'train' or tr is None or not tr.get('steps'):
        return None
    k2_s = devtrace.device_seconds(tr, 'flash_bwd_')
    if k2_s <= 0:
        return None
    d = run['dims']
    bound = tr['steps'] * d['layers'] * yardstick.flash_bwd_bound_s(
        run['batch'], run['seq'], run['seq'], d['h'], d['kvh'], d['d'])
    return 100.0 * bound / k2_s
