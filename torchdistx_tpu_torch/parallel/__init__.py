"""Training and sharding (counterpart of ``torchdistx_tpu.parallel``): the
train steps, SlowMo, the ``fit`` loop, process-group init and cross-process
flag agreement, device meshes (hybrid too) and sharding plans."""

from .mesh import MeshSpec, make_mesh  # noqa: F401
from .distributed import (  # noqa: F401
    ProcessInfo,
    any_flag,
    any_flags,
    initialize,
    make_hybrid_mesh,
)
from .sharding import (  # noqa: F401
    PartitionSpec,
    combine_plans,
    fsdp_over,
    fsdp_plan,
    replicated_plan,
    tp_plan_gpt2,
    tp_plan_llama,
)
from .slowmo import (  # noqa: F401
    SlowMomentumOptimizer,
    SlowMoState,
    load_slowmo_state_dict,
    slowmo_grad_sync,
    slowmo_state_dict,
)
