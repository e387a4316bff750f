r"""``irfft2_kernel``'s share of its roofline: the least time the traced segments' irfft2 transforms need
(``portbench.counts.solver_bound_ms``) over the kernel's summed device time in the trace, in percent."""

from portbench.counts import solver_bound_ms
from portbench.trace import kernel_seconds


def read(run):
    trace = run['trace']
    if run['work']['driver'] != 'solver' or not trace:
        return None
    seconds, launches = kernel_seconds(trace['dev'], r'irfft2_kernel')
    if not launches:
        return None
    tr = run['work']['traffic']
    bound_ms = trace['units'] * solver_bound_ms(run['config'], tr['batch'], tr['segment'], 'irfft2')
    return 100 * bound_ms / (1e3 * seconds)
