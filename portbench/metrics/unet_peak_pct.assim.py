r"""The window kernel's rate on the cell's own traffic: its analytic forward FLOPs per window times the
program's ``unet.windows`` counter, over the summed device time of the operations launched inside the
``windowed.kernel`` spans (forwards, with grad, and remat's recomputes), over the card's peak, in percent."""

from portbench import spans
from portbench.counts import window_flops


def read(run):
    reading = spans.trusted(spans.reading(run))
    if reading is None or run['work']['driver'] != 'assim':
        return None
    seconds = spans.device_seconds(reading, 'windowed.kernel')
    if not seconds:
        return None
    return 100 * window_flops(run['config']) * reading['counters']['unet.windows'] / seconds / run['peak_flops']
