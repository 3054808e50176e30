"""PyTorch/CUDA port of pyramid_flow_tpu for one NVIDIA H100.

Same module layout as ``pyramid_flow_tpu``; the JAX package stays the
reference the port is tested against. Importing this package imports torch
and numpy only.
"""

__version__ = "0.1.0"
