"""rcot_torch: RCOT on PyTorch and CUDA for NVIDIA Hopper (H100).

The counterpart of `rcot_tpu/` written for one H100. Activations are
(B, H, W, C) at every public function, as in the JAX package, and module
parameters carry the reference PyTorch model's state_dict names. The
transformer blocks run through hand-written CUDA kernels (`csrc/`) when
their tensors lie on a CUDA device and through plain PyTorch twins on the
CPU. The package imports nothing of JAX.
"""
