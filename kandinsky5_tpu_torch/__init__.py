"""Kandinsky-5 T2V Lite in PyTorch, with hand-written CUDA kernels for the
NVIDIA H100.

The port of ``kandinsky5_tpu`` (JAX/Pallas): each module keeps the name of
its JAX counterpart. Importing the package needs neither CUDA nor JAX; the
kernels in ``csrc/`` are compiled at their first launch.
"""

from kandinsky5_tpu_torch.config import Config, load_config

__all__ = ["Config", "load_config"]
