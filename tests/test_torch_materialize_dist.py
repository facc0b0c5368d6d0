"""The port's sharded materialization over ``torch.distributed``, on 2 and 4
CPU ranks over gloo, in subprocesses (``_torch_materialize_dist_child.py``;
a ``FileStore`` in a temporary directory, no ports, 60 s a rank so that a
hang fails and does not stall the suite).  All cases' ranks start at once.

Each rank checks that its local shard of every parameter is bit-equal to
its slice of the unsharded materialization and that the gathered tensor is
the unsharded one.  Here the placements the ranks report are held against
the specs of JAX's ``materialize_module_jax(...)[name].sharding.spec`` for
the same model, plan and mesh shape, on the JAX package's virtual CPU
devices: mesh dim ``i`` is ``Shard(d)`` exactly when its axis is in entry
``d`` of the JAX spec.
"""

import json
import os
import subprocess
import sys

import jax
import pytest

import torchdistx_tpu.deferred_init as jdi
from torchdistx_tpu.materialize import materialize_module_jax
from torchdistx_tpu.parallel import (
    MeshSpec,
    fsdp_over,
    fsdp_plan,
    make_mesh,
    tp_plan_gpt2,
    tp_plan_llama,
)

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_materialize_dist_child.py")
ROOT = os.path.dirname(HERE)


CASES = {"fsdp4": 4, "fsdp2_tp2": 4, "tp2": 2}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every case's ranks, started together so that their start-up overlaps
    with each other and with the JAX side: ``{case: (dir, processes)}``."""
    env = dict(os.environ, USE_TF="0", USE_FLAX="0", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    runs = {}
    for case, world in CASES.items():
        d = tmp_path_factory.mktemp(case)
        runs[case] = (d, [
            subprocess.Popen(
                [sys.executable, CHILD, case, str(rank), str(world), str(d / "store"),
                 str(d / f"rank{rank}.json")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(world)
        ])
    yield runs
    for _, procs in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _reports(case, d, procs):
    """Each rank's report, once all ranks of ``case`` exited 0 (60 s each)."""
    outs = [p.communicate(timeout=60)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {case} exited {p.returncode}:\n{out[-3000:]}"
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(len(procs))]


def _jax_placements(case):
    """``{name: ["S0", "R", ...]}`` from the specs of JAX's materialization of
    the case's model, plan and mesh shape (the child's ``_case``)."""
    sys.path.insert(0, HERE)
    try:
        import _torch_materialize_dist_child as child
    finally:
        sys.path.remove(HERE)
    spec, _, build = child._case(case)
    jplan = {"fsdp4": lambda: fsdp_plan(min_size=1),
             "fsdp2_tp2": lambda: fsdp_over(tp_plan_llama()),
             "tp2": tp_plan_gpt2}[case]()
    jspec = MeshSpec(**{name: size for name, size in spec.axes()})
    mesh = make_mesh(jspec, devices=jax.devices()[:jspec.size])
    out = materialize_module_jax(jdi.deferred_init(build), mesh=mesh, plan=jplan, seed=7)
    placements = {}
    for name, arr in out.items():
        entries = list(arr.sharding.spec)
        row = []
        for axis in mesh.axis_names:
            dims = [d for d, e in enumerate(entries)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            row.append(f"S{dims[0]}" if dims else "R")
        placements[name] = row
    return list(mesh.axis_names), placements


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_materialize_matches_unsharded_and_jax_specs(case, launched):
    axes, want = _jax_placements(case)
    reports = _reports(case, *launched[case])
    assert len(reports) == CASES[case]
    for rank, rep in enumerate(reports):
        assert rep["mesh"] == axes, rank
        assert set(rep["params"]) == set(want), rank
        for name, got in rep["params"].items():
            assert got["placements"] == want[name], (rank, name)
    # Something was sharded, on every axis of the mesh.
    for i in range(len(axes)):
        assert any(p["placements"][i] != "R" for p in reports[0]["params"].values()), axes[i]
