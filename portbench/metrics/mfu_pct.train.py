r"""The train cell's analytic FLOPs over the untraced window, over the card's published peak for the
configuration's dtype (``portbench.counts``), in percent."""

def read(run):
    if not run['cuda'] or run['work']['driver'] != 'train':
        return None
    return 100 * run['flops_per_count'] * run['counts'] / run['window_s'] / run['peak_flops']
