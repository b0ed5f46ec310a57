"""Tensor parallelism for the port's DiT: the plan (:mod:`.sharding`) and
the rank processes (:mod:`.ranks`)."""

from kandinsky5_tpu_torch.parallel.ranks import TensorParallel, launch

__all__ = ["TensorParallel", "launch"]
