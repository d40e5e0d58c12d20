"""Mean submit-to-admission wait in the replica's scheduler over the
window: the deltas of ``skytpu_serve_queue_wait_ms``'s sum and count."""
from perfbench import promtext


def read(run):
    if run['kind'] != 'serve' or not run['metrics_after']:
        return None
    return promtext.delta_mean(run['metrics_before'], run['metrics_after'],
                               'skytpu_serve_queue_wait_ms')
