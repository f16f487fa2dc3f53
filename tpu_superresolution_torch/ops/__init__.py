"""Tensor ops of the port (plain torch; the hand-written kernels live in
``tpu_superresolution_torch.kernels``)."""
