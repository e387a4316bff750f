r"""Milliseconds per transition of the cell's fields: the untraced window over
every transition it completed. Per layer, and not end to end, because the
host-bound solver's runs spread more than any bound allows (``PERF.md``)."""

def read(run):
    if not run['cuda'] or run['work']['driver'] != 'solver':
        return None
    return 1e3 * run['window_s'] / run['counts']
