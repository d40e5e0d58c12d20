"""Model FLOPs of the traced steps over their span on the host's clock
(each step ends synced) times the card's bf16 peak (989 TFLOP/s), in %;
recomputation is not counted."""
from perfbench import yardstick


def read(run):
    tr = run.get('trace')
    if run['kind'] != 'train' or tr is None or not tr.get('steps'):
        return None
    flops = tr['steps'] * yardstick.train_step_flops(
        run['dims'], run['batch'], run['seq'])
    return 100.0 * flops / (tr['window_s'] * yardstick.PEAK_BF16_FLOPS)
