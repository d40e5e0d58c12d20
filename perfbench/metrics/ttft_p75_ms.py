"""Client-side TTFT p75 over every request due in the window, from when
it was due to its first streamed token. p75: a conversation window holds
some 40 requests, ten of them beyond it."""
from perfbench import readers, stats


def read(run):
    if run['kind'] != 'serve':
        return None
    return stats.percentile(readers.ttfts_ms(run), 75)
