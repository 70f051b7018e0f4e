"""The benchmark of wekws_tpu_torch on an NVIDIA GPU (README.md)."""
