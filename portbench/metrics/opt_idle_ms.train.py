r"""Per training step, the device's idle time (the gaps between its merged operation intervals) that
falls inside the program's ``train.optimizer`` spans, in milliseconds.

The window profiles every host operator, which slows this host-bound step: there a step takes 2.2-2.7
times an untraced step of the same run (``PERF.md`` section 5), and most of what it adds is idle. So the
value is larger than an untraced step's idle in the phase, most of all in the phase with the most host
operators (the backward); it compares runs with each other, not with ``train_step_ms``."""

from portbench import spans


def read(run):
    reading = spans.trusted(spans.reading(run))
    if reading is None or run['work']['driver'] != 'train':
        return None
    return 1e3 * spans.idle_seconds(reading, 'train.optimizer') / reading['counts']
