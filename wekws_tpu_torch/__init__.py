"""PyTorch/CUDA port of wekws_tpu for NVIDIA Hopper.

Same sub-packages as the JAX package (frontend, data, models, losses,
train, ops, text, decode, runtime, eval, tools).  Imports torch and numpy, never JAX or wekws_tpu.  The
hand-written CUDA kernels live in ``csrc/`` and are built at first use
(ops/cuda_build.py).
"""
