"""Training and sharding (counterpart of ``torchdistx_tpu.parallel``): the
train steps, SlowMo, the ``fit`` loop, process-group init and cross-process
flag agreement, device meshes (hybrid too), sharding plans and their
``DTensor`` placements.  As in the JAX package, the train steps and ring
attention import from their own modules (``parallel.train_step``,
``parallel.ring_attention``)."""

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
    batch_sharding,
    combine_plans,
    fit_shardings,
    fit_spec_to_mesh,
    fsdp_over,
    fsdp_plan,
    replicate_indivisible,
    replicated_plan,
    spec_placements,
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
