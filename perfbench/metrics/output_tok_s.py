"""Output tokens the client received inside the window, over the window:
those of the scheduled requests and of the steady-state set."""
from perfbench import readers


def read(run):
    if run['kind'] != 'serve':
        return None
    start, close_at = run['window']
    n = sum(1 for r in readers.all_records(run) for t in r.token_times
            if start <= t < close_at)
    return n / (close_at - start)
