r"""The share of the U-Net's residual-block calls that ran on the channels-last kernels: 100 times the
program's ``unet.blocks_fused`` counter (blocks whose ``norm_pad`` kernel launched) over its ``unet.blocks``,
over the spans' window (training steps). A program without those counters gives nothing."""

from portbench import spans


def read(run):
    reading = spans.reading(run)
    if reading is None or run['work']['driver'] != 'train' or not reading['counters'].get('unet.blocks'):
        return None
    return 100 * reading['counters'].get('unet.blocks_fused', 0) / reading['counters']['unet.blocks']
