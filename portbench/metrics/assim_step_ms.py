r"""Milliseconds per sampler step (predictor and corrections): the window over every step it completed."""

def read(run):
    if not run['cuda'] or run['work']['driver'] != 'assim':
        return None
    return 1e3 * run['window_s'] / run['counts']
