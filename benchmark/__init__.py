"""The benchmark of mpas_tpu_torch on one NVIDIA H100: `run.py` runs one
cell once. It reads the port and its kernels' names, never the JAX package."""
