"""p75 over the window's requests with two or more tokens of each one's
(last token - first token) / (tokens - 1)."""
from perfbench import readers, stats


def read(run):
    if run['kind'] != 'serve':
        return None
    return stats.percentile(readers.tpots_ms(run), 75)
