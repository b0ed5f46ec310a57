"""The port's mesh: the DiT's (dp, sp, tp) plan (:mod:`.sharding`) and
the rank processes with their tp, sp and dp groups (:mod:`.ranks`)."""

from kandinsky5_tpu_torch.parallel.ranks import (
    DataParallel,
    RankMesh,
    SequenceParallel,
    TensorParallel,
    hybrid_rank_grid,
    launch,
)

__all__ = ["DataParallel", "RankMesh", "SequenceParallel", "TensorParallel",
           "hybrid_rank_grid", "launch"]
