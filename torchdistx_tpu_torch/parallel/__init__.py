"""Training and sharding (counterpart of ``torchdistx_tpu.parallel``): the
single-device train step, the ``fit`` loop, cross-process flag agreement,
device meshes and sharding plans."""

from .mesh import MeshSpec, make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    PartitionSpec,
    combine_plans,
    fsdp_over,
    fsdp_plan,
    replicated_plan,
    tp_plan_gpt2,
    tp_plan_llama,
)
