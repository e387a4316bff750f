r"""The share of the window kernel's window-forwards that the sampler uses: samples x (length - window + 1)
windows x (1 + corrections) evaluations x steps, over the program's ``unet.windows`` counter (pad windows
and remat's recomputes included) over the same units, in percent."""

from portbench import spans


def read(run):
    reading = spans.reading(run)
    if reading is None or run['work']['driver'] != 'assim' or not reading['counters'].get('unet.windows'):
        return None
    tr = run['work']['traffic']
    useful = tr['samples'] * (tr['length'] - run['config']['window'] + 1) * (1 + tr['corrections']) * reading['counts']
    return 100 * useful / reading['counters']['unet.windows']
