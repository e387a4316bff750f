r"""The guided evaluation's input VJP against its forward: the summed device time of the operations
launched inside the ``guidance.vjp`` spans (remat's recompute included) over that inside the
``guidance.forward`` spans."""

from portbench import spans


def read(run):
    reading = spans.trusted(spans.reading(run))
    if reading is None or run['work']['driver'] != 'assim':
        return None
    forward = spans.device_seconds(reading, 'guidance.forward')
    return spans.device_seconds(reading, 'guidance.vjp') / forward if forward else None
