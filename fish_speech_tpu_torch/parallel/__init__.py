"""Multi-device serving and training on `torch.distributed` (one process
per card): the mesh, the Megatron layout of the Dual-AR tree and the
collectives the sharded model runs (`parallel/mesh.py`,
`parallel/collectives.py`), and the multi-rank dry run
(`parallel/dryrun.py`)."""

from fish_speech_tpu_torch.parallel.mesh import (
    Mesh, batch_spec, dual_ar_param_specs, init_distributed, kv_cache_specs,
    make_mesh, shard_params, train_state_memory_plan, unshard_params,
    zero1_shard_opt_state)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "dual_ar_param_specs",
    "kv_cache_specs",
    "batch_spec",
    "shard_params",
    "unshard_params",
    "zero1_shard_opt_state",
    "train_state_memory_plan",
]
