"""Kandinsky-5 T2V Lite in PyTorch, with hand-written CUDA kernels for the
NVIDIA H100.

The port of ``kandinsky5_tpu`` (JAX/Pallas): each module keeps the name of
its JAX counterpart. Importing the package needs neither CUDA nor JAX; the
kernels in ``csrc/`` are compiled at their first launch. Like the JAX
package it exports ``get_default_conf`` and ``get_T2V_pipeline``, the
latter imported lazily (``pipeline`` loads the models on first use).
"""

from kandinsky5_tpu_torch.config import Config, get_default_conf, load_config

__all__ = ["Config", "get_T2V_pipeline", "get_default_conf", "load_config"]


def __getattr__(name):
    if name == "get_T2V_pipeline":
        from kandinsky5_tpu_torch.pipeline import get_T2V_pipeline

        return get_T2V_pipeline
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
