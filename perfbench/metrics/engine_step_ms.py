"""Mean engine step (dispatch) time over the window: the deltas of
``skytpu_engine_step_ms``'s sum and count."""
from perfbench import promtext


def read(run):
    if run['kind'] != 'serve' or not run['metrics_after']:
        return None
    return promtext.delta_mean(run['metrics_before'], run['metrics_after'],
                               'skytpu_engine_step_ms')
