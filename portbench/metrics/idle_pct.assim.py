r"""The device's idle share of the traced window: 100 minus the union of every device operation's
interval over the window, in percent."""

from portbench.trace import idle_pct


def read(run):
    if run['work']['driver'] != 'assim':
        return None
    return idle_pct(run)
