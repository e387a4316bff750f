r"""Seconds of set-up: reading the parameters, building the program, warming up the cell's shapes."""

def read(run):
    return run['setup_s'] if run['cuda'] else None
