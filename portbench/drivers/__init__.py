r"""One driver per kind of cell: set-up, one unit of timed work, the outputs
kept for the comparison, and the analytic count of that work. The score
network comes from the configuration's arch (``portbench/archs``)."""
