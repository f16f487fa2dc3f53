"""tpu_superresolution_torch — the PyTorch + CUDA port of
``tpu_superresolution_tpu`` for NVIDIA Hopper (H100).

The port runs the SwinIR serving path (decode -> tiled whole-image
SwinIR -> PNG, ``cli/serve.py``) with hand-written sm_90a kernels for the
Swin block, LayerNorm and the NHWC convs (``kernels/``).  It imports
torch, numpy and the standard library only; the JAX package in the same
repository is the reference it is tested against.
"""

__version__ = "0.1.0"
