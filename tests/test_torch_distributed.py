"""The port's process-group init and hybrid meshes
(``parallel/distributed.py``) against the JAX package's
(``tests/test_distributed.py``).

The rank layout of ``make_hybrid_mesh`` is a pure function of the specs and
the ranks' hosts (``_hybrid_ranks``), held exactly against the JAX
``mesh.devices`` ids on the JAX package's 8 virtual CPU devices (one
process there, whose granule fallback splits the flat device list; here one
host on the CPU).  Then a 4-rank gloo mesh in subprocesses
(``_torch_slowmo_child.py``, suite ``mesh``; 60 s a rank) and ``initialize``
in a 1-process group, called twice.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from torchdistx_tpu.parallel import MeshSpec as JaxMeshSpec
from torchdistx_tpu.parallel import distributed as jdist
from torchdistx_tpu.parallel import make_hybrid_mesh as jax_hybrid_mesh
from torchdistx_tpu_torch.parallel import MeshSpec, ProcessInfo
from torchdistx_tpu_torch.parallel import distributed as tdist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from _torch_slowmo_child import ROOT, launch, wait  # noqa: E402

# (ici, dcn) of each layout case of tests/test_distributed.py, as axis dicts.
LAYOUTS = {
    "dcn_major": ({"tp": 2}, {"dp": 4}),
    "axis_factor_merge": ({"fsdp": 2, "tp": 2}, {"fsdp": 2}),
    "trivial_dcn": ({"fsdp": 4, "tp": 2}, {}),
    "dp2_tp4": ({"tp": 4}, {"dp": 2}),
}


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """The 4 ranks' reports of the ``mesh`` suite, by rank."""
    d = tmp_path_factory.mktemp("mesh")
    procs = launch("mesh", 4, d)
    wait(procs, "the mesh suite")
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]


def _jax_ids(ici, dcn, devices=None, granules=None, monkeypatch=None):
    """(axis names, device ids) of the JAX ``make_hybrid_mesh``; with
    ``granules`` (lists of device indices) its granule grouping is that."""
    devices = devices or jax.devices()
    if granules is not None:
        monkeypatch.setattr(jdist, "_slice_granules",
                            lambda devs: [[devs[i] for i in g] for g in granules])
    mesh = jax_hybrid_mesh(JaxMeshSpec(**ici), JaxMeshSpec(**dcn), devices=devices)
    return tuple(mesh.axis_names), np.vectorize(lambda dev: dev.id)(mesh.devices)


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_hybrid_layout_matches_jax(case):
    ici, dcn = LAYOUTS[case]
    names, ids = _jax_ids(ici, dcn)
    got_names, ranks = tdist._hybrid_ranks(MeshSpec(**ici), MeshSpec(**dcn), ["h"] * 8, "cpu")
    assert got_names == names
    np.testing.assert_array_equal(ranks, ids)


@pytest.mark.parametrize("hosts, granules", [
    ([0] * 4 + [1] * 4, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    ([r % 2 for r in range(8)], [[0, 2, 4, 6], [1, 3, 5, 7]]),
    (["b"] * 4 + ["a"] * 4, [[4, 5, 6, 7], [0, 1, 2, 3]]),
], ids=["host_major", "interleaved", "sorted_names"])
@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_hybrid_layout_by_host_matches_jax_granules(hosts, granules, device_type,
                                                    monkeypatch):
    # Ranks on two hosts form one granule each, in sorted host order: the
    # layout JAX builds from the same granules.
    assert tdist._slice_granules(hosts) == granules
    names, ids = _jax_ids({"tp": 4}, {"dp": 2}, granules=granules, monkeypatch=monkeypatch)
    got = tdist._hybrid_ranks(MeshSpec(tp=4), MeshSpec(dp=2), hosts, device_type)
    assert got[0] == names
    np.testing.assert_array_equal(got[1], ids)


def test_hybrid_mesh_size_mismatch():
    with pytest.raises(ValueError, match="needs 16 devices") as want:
        jax_hybrid_mesh(JaxMeshSpec(tp=4), JaxMeshSpec(dp=4), devices=jax.devices())
    with pytest.raises(ValueError, match="needs 16 devices") as got:
        tdist._hybrid_ranks(MeshSpec(tp=4), MeshSpec(dp=4), ["h"] * 8, "cpu")
    assert str(got.value) == str(want.value)


def test_hybrid_mesh_rejects_contradicting_granules(monkeypatch):
    # Four hosts of two ranks cannot be two DCN granules: both raise rather
    # than lay intra-host axes across hosts.
    monkeypatch.setattr(jdist, "_slice_granules", lambda devs: [devs[i::4] for i in range(4)])
    with pytest.raises(ValueError, match="DCN granule"):
        jax_hybrid_mesh(JaxMeshSpec(tp=4), JaxMeshSpec(dp=2), devices=jax.devices())
    with pytest.raises(ValueError, match="Requested 2 DCN granule"):
        tdist._hybrid_ranks(MeshSpec(tp=4), MeshSpec(dp=2), [r % 4 for r in range(8)], "cpu")


def test_one_host_is_degenerate_only_on_the_cpu():
    # The reference's shared degeneracy rule: one host on the CPU is the
    # test rig (a contiguous split); on CUDA it is a real single-host
    # topology, and asking it for two DCN granules raises.
    assert tdist._degenerate_cpu_slices(["h"] * 8, "cpu")
    assert not tdist._degenerate_cpu_slices(["h"] * 8, "cuda")
    assert not tdist._degenerate_cpu_slices(["h", "g"] * 4, "cpu")
    _, ranks = tdist._hybrid_ranks(MeshSpec(tp=4), MeshSpec(dp=2), ["h"] * 8, "cpu")
    assert ranks.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="Requested 2 DCN granule.*form 1"):
        tdist._hybrid_ranks(MeshSpec(tp=4), MeshSpec(dp=2), ["h"] * 8, "cuda")


def test_host_keys_from_local_world_size(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert tdist._host_keys(8) == [0, 0, 0, 0, 1, 1, 1, 1]


def test_world_info_without_a_group():
    assert tdist.world_info() == ProcessInfo(0, 1, 1, 1)


def test_gloo_mesh_and_collectives_across_both_axes(mesh_ranks):
    # make_hybrid_mesh(tp=2 | dp=2) on 4 gloo ranks: the layout of the pure
    # function and of JAX's mesh over 4 devices; an all-reduce over dp, then
    # over tp, sums all 4 ranks (0 + 1 + 2 + 3).
    names, ids = _jax_ids({"tp": 2}, {"dp": 2}, devices=jax.devices()[:4])
    for rank, rep in enumerate(mesh_ranks):
        assert tuple(rep["names"]) == names
        assert rep["ranks"] == ids.tolist()
        i, j = rep["coord"]
        assert ids[i, j] == rank
        assert rep["after_dp"] == float(sum(ids[:, j]))
        assert rep["after_both"] == 6.0
        assert rep["info"] == [rank, 4, 1, 4] == rep["adopted"]
        assert rep["two_hosts"] == [[0, 1], [2, 3]]
        assert "Requested 2 DCN granule(s) but the devices form 4" in rep["four_hosts"]


def test_initialize_single_process_group():
    """A real rendezvous, 1-process world, in a subprocess (the process
    group is process-global state), called twice."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = (
        "import torch.distributed as dist\n"
        "from torchdistx_tpu_torch.parallel import initialize\n"
        f"info = initialize('127.0.0.1:{port}', num_processes=1, process_id=0, device='cpu')\n"
        "assert info.process_count == 1 and info.process_index == 0, info\n"
        "assert info.local_device_count == info.global_device_count\n"
        "assert dist.get_backend() == 'gloo'\n"
        "info2 = initialize(device='cpu')  # idempotent\n"
        "assert info2 == info\n"
        "dist.destroy_process_group()\n"
        "print('INIT-OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env)
    assert "INIT-OK" in out.stdout, out.stderr[-2000:]
