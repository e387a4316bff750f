r"""Milliseconds per AdamW step: the window over every step it completed."""

def read(run):
    if not run['cuda'] or run['work']['driver'] != 'train':
        return None
    return 1e3 * run['window_s'] / run['counts']
