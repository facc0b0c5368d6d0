#!/usr/bin/env python3
"""How far the port's mesh train step and the JAX package's drift from
their own unsharded steps under AdamW at a small ``eps`` (ROADMAP C4).

    JAX_PLATFORMS=cpu python3 scripts/torch_mesh_eps_probe.py [eps ...]   # default 1e-8 1e-5

Starts 4 gloo ranks on the CPU (``tests/_torch_mesh_child.py``, suite
``eps``): Llama (``llama_test``) under ``MeshSpec(fsdp=2, tp=2)`` and MoE
(``moe_test``) under ``dp=2, fsdp=2``, three AdamW steps from the JAX
``init_fn``'s weights on the mesh tests' batches, and the same steps on one
device.  Beside them runs the JAX ``make_train_step`` on the same mesh
shapes and on one device (virtual CPU devices).  Prints, for each eps and
family, the largest absolute difference over every parameter after the
third step (and over the three losses) of: the port's mesh step against
its unsharded step, the JAX mesh step against its unsharded step, and the
port's mesh and unsharded steps against the JAX unsharded step; then, for
Llama, the port's step with one kind of axis at a time (``fsdp=4``,
``dp=4``: the batch split; ``tp=4``: tensor parallelism) against the
unsharded step, with the parameter that differs most.  Needs the JAX package (the reference) and about a minute.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


# Llama's mesh step with one kind of axis at a time: the batch split over 4
# ranks (its gradients reduce-scattered), and tensor parallelism over 4
# (the batch whole on every rank).
BISECT = {"fsdp4": {"fsdp": 4}, "dp4": {"dp": 4}, "tp4": {"tp": 4}}


def main(eps_values):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import test_torch_train_step_mesh as t
    from _torch_mesh_child import launch, wait

    params = {f: jax.tree.map(np.asarray, t._jax_init(f, t.JaxMeshSpec(fsdp=2, tp=2))[1].params)
              for f in ("llama", "moe")}
    inputs = {"adamw": t.ADAMW, "batches": t._batches(), "eps": eps_values,
              "eps_bisect": BISECT,
              **{f"{f}_params": p for f, p in params.items()}}
    with tempfile.TemporaryDirectory() as d:
        procs = launch("eps", 4, Path(d), inputs)
        try:
            jax_runs = {(f, eps, where): t._jax_run_eps(f, spec, params[f], eps)
                        for eps in eps_values
                        for f, spec in (("llama", t.JaxMeshSpec(fsdp=2, tp=2)),
                                        ("moe", t.JaxMeshSpec(dp=2, fsdp=2)))
                        for where, spec in (("mesh", spec), ("single", None))}
        finally:
            port = wait(procs, Path(d), "the eps suite")
    rows = {}
    for eps in eps_values:
        for f in ("llama", "moe"):
            pm, ps = port[f"{f}_mesh_{eps}"], port[f"{f}_single_{eps}"]
            jm, js = jax_runs[(f, eps, "mesh")], jax_runs[(f, eps, "single")]
            rows[f"{f} eps {eps}"] = {
                "port_mesh_vs_port_single": t._max_diff(pm, ps),
                "jax_mesh_vs_jax_single": t._max_diff_jax(jm, js),
                "port_mesh_vs_jax_single": t._max_diff_port_jax(f, pm, js, params[f]),
                "port_single_vs_jax_single": t._max_diff_port_jax(f, ps, js, params[f]),
            }
        for name in BISECT:
            pm, ps = port[f"llama_{name}_{eps}"], port[f"llama_single_{eps}"]
            worst = max(ps["params"], key=lambda k: float(np.max(np.abs(
                pm["params"][k] - ps["params"][k]))))
            rows[f"llama {name} eps {eps}"] = {
                "port_mesh_vs_port_single": t._max_diff(pm, ps), "worst_parameter": worst}
    print(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main([float(x) for x in sys.argv[1:]] or [1e-8, 1e-5]))
