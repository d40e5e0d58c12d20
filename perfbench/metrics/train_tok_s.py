"""Tokens of every step the window holds, over the window (each step
ends in a device synchronize)."""


def read(run):
    if run['kind'] != 'train':
        return None
    return run['tokens'] / run['window_s']
