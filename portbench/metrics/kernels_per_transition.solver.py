r"""Device kernels (copies and fills left out) in the traced window, per transition."""

from portbench.trace import is_kernel


def read(run):
    trace = run['trace']
    if run['work']['driver'] != 'solver' or not trace or not trace['dev']:
        return None
    return sum(is_kernel(name) for name, _, _ in trace['dev']) / trace['counts']
