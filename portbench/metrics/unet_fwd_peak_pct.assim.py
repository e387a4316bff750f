r"""The window kernel's forward over the cell's windows (CUDA events around the trajectory eps without
gradient), its analytic FLOPs over that time and the card's peak, in percent."""

def read(run):
    probes = run['probes']
    if 'forward_s' not in probes:
        return None
    return 100 * probes['forward_flops'] / probes['forward_s'] / run['peak_flops']
