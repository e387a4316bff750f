r"""sda_tpu_torch — the PyTorch/CUDA port of ``sda_tpu`` for NVIDIA Hopper.

A second package beside the JAX reference ``sda_tpu``, with the same module
paths, the same public layouts (channel-first fields, spectra as ``(re, im)``
pairs) and the same committed weights. It imports ``torch`` and never JAX.
The fused DFT pair that ``sda_tpu`` wrote in Pallas is a CUDA C++ kernel pair
here (``csrc/dft.cu``), built with ``nvcc`` at first use and bound with
``ctypes``.

Entry points take ``device=`` and default to ``'cuda'``; they raise when no
card is present unless the caller asks for ``device='cpu'``.
"""

__version__ = '0.1.0'
