r"""The DiT's attention kernel against the card's peak on the cell's own traffic: the attention's forward
FLOPs per window and block, ``4 N^2 D`` (``archs/dit.py``, frozen from shapes whatever kernel computes
them), times the program's ``dit.attention`` counter (windows of each attention call, summed), over the
summed device time of the operations launched inside the ``dit.attention`` spans, over the card's peak,
in percent. A program or an arch without those spans and counter gives nothing."""

from portbench import archs, spans


def read(run):
    reading = spans.trusted(spans.reading(run))
    if reading is None or run['work']['driver'] != 'assim' or not reading['counters'].get('dit.attention'):
        return None
    seconds = spans.device_seconds(reading, 'dit.attention')
    if not seconds:
        return None
    flops = archs.of(run['config']).attention_flops(run['config']) * reading['counters']['dit.attention']
    return 100 * flops / seconds / run['peak_flops']
