"""The port's mesh: the DiT's tensor-parallel plan (:mod:`.sharding`) and
the rank processes with their tp and dp groups (:mod:`.ranks`)."""

from kandinsky5_tpu_torch.parallel.ranks import (
    DataParallel,
    RankMesh,
    TensorParallel,
    launch,
)

__all__ = ["DataParallel", "RankMesh", "TensorParallel", "launch"]
