r"""Per transition, the device's idle time (the gaps between its merged operation intervals) that falls
inside the program's ``kolmogorov.substep`` spans, in milliseconds.

The window profiles every host operator, which slows this host-bound solver: there a transition takes
1.6-2.0 times an untraced transition of the same run (``PERF.md`` section 5), and most of what it adds is
idle. So the value is larger than an untraced transition's idle in substeps; it compares runs with each
other, not with ``transition_ms.solver``."""

from portbench import spans


def read(run):
    reading = spans.trusted(spans.reading(run))
    if reading is None or run['work']['driver'] != 'solver':
        return None
    return 1e3 * spans.idle_seconds(reading, 'kolmogorov.substep') / reading['counts']
