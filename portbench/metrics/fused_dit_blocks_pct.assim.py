r"""The share of the DiT's block calls whose three adaLN glue sites ran on the hand-written kernels: 100
times the program's ``dit.blocks_fused`` counter over its ``dit.blocks``, over the spans' window (guided
segments). A program without ``dit.blocks_fused``, or a cell without DiT blocks, gives nothing."""

from portbench import spans


def read(run):
    reading = spans.reading(run)
    if reading is None or run['work']['driver'] != 'assim':
        return None
    counters = reading['counters']
    if not counters.get('dit.blocks') or 'dit.blocks_fused' not in counters:
        return None
    return 100 * counters['dit.blocks_fused'] / counters['dit.blocks']
