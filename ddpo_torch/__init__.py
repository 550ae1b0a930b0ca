"""ddpo_torch: the PyTorch/CUDA port of ddpo_tpu for NVIDIA Hopper GPUs.

Mirrors ddpo_tpu's subpackage layout and module names, so each module's JAX
counterpart sits at the same path under ddpo_tpu/. Plain tensor code is
PyTorch; the ops that ddpo_tpu wrote as Pallas TPU kernels are CUDA kernels
written for sm_90a (ddpo_torch/csrc), built at first use on a CUDA tensor.
The package imports neither jax nor ddpo_tpu.
"""

__version__ = "0.1.0"
