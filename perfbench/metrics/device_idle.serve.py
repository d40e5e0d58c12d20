"""Share of the traced serving window in which no operation ran on the
card, in %."""


def read(run):
    tr = run.get('trace')
    if run['kind'] != 'serve' or tr is None or tr['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
