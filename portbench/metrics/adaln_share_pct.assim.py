r"""The DiT's memory-bound glue against its whole forward on the cell's own traffic: the summed device
time of the operations launched inside the program's ``dit.adaln`` spans (each block's two
LayerNorm-and-modulate sites and its two gated residual adds) over that inside the ``windowed.kernel``
spans, in percent. A program or an arch without those spans gives nothing."""

from portbench import spans


def read(run):
    reading = spans.trusted(spans.reading(run))
    if reading is None or run['work']['driver'] != 'assim' or 'dit.adaln' not in reading['spans']:
        return None
    kernel = spans.device_seconds(reading, 'windowed.kernel')
    return 100 * spans.device_seconds(reading, 'dit.adaln') / kernel if kernel else None
