#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives the gloo backend runs on CUDA
tensors, with several ranks sharing one card.

    python3 scripts/torch_gloo_cuda_probe.py [world [op ...]]   # default 4 ranks, all ops

(``TDX_PROBE_DEVICE=cpu`` runs the same operations on CPU tensors, to
check the script itself on a host without a card.)

For each collective that the port's mesh step and ring attention issue,
starts ``world`` processes over gloo (a ``FileStore`` in a temp dir), every
rank on ``cuda:0``, that run that one operation on the world group (a gloo
fault can abort the process, so each operation has processes of its own);
then, in one more group, builds ``make_mesh(MeshSpec(fsdp=2, tp=world //
2), device_type="cuda")`` and runs an all-reduce over its ``fsdp`` group.
Prints one line per operation: ``ok`` (the result checked against the
expected values), the exception's type and first line, or the ranks' exit
codes and the last line of their output when a rank did not exit 0, or
that a rank did not exit within a minute; then
the card's name and power limit.  Exits 0 when every operation was probed.
"""

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = os.environ.get("TDX_PROBE_DEVICE", "cuda")
TIMEOUT_S = 60


def _op(dist, torch, group, label, only):
    """``{label.only: "ok" | error}`` for the collective ``only`` over
    ``group`` (a name ending in ``_bf16``: on bfloat16 tensors)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device("cpu")
    name = only.removesuffix("_bf16")
    dtype = torch.bfloat16 if only.endswith("_bf16") else torch.float32
    out = {}

    def attempt(name, fn):
        try:
            fn()
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            out[f"{label}.{name}"] = "ok"
        except Exception as e:  # the probe's result is the exception itself
            msg = str(e).strip().splitlines()[0][:200] if str(e).strip() else ""
            out[f"{label}.{name}"] = f"{type(e).__name__}: {msg}"

    def all_reduce():
        t = torch.full((4,), float(me + 1), device=dev, dtype=dtype)
        dist.all_reduce(t, group=group)
        assert t.tolist() == [n * (n + 1) / 2] * 4, t

    def all_reduce_max():
        t = torch.tensor([me], dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        assert t.item() == n - 1

    def all_gather_into_tensor():
        t = torch.full((2, 3), float(me), device=dev, dtype=dtype)
        o = torch.empty((2 * n, 3), device=dev, dtype=dtype)
        dist.all_gather_into_tensor(o, t, group=group)
        assert o[::2, 0].tolist() == [float(i) for i in range(n)], o

    def reduce_scatter_tensor():
        t = (torch.arange(2 * n, dtype=torch.float32, device=dev) + me).to(dtype)
        o = torch.empty(2, device=dev, dtype=dtype)
        dist.reduce_scatter_tensor(o, t, group=group)
        want = [float(n * (2 * me + j) + n * (n - 1) / 2) for j in range(2)]
        assert o.tolist() == want, (o, want)

    def all_to_all_single():
        t = torch.full((n,), float(me), device=dev)
        o = torch.empty(n, device=dev)
        dist.all_to_all_single(o, t, group=group)
        assert o.tolist() == [float(i) for i in range(n)], o

    def broadcast():
        t = torch.full((3,), float(me), device=dev)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        assert t.tolist() == [0.0] * 3

    def batch_isend_irecv():
        nxt = dist.get_global_rank(group, (me + 1) % n)
        prv = dist.get_global_rank(group, (me - 1) % n)
        send = torch.full((5,), float(me), device=dev)
        recv = torch.empty(5, device=dev)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                       dist.P2POp(dist.irecv, recv, prv, group)])
        for r in reqs:
            r.wait()
        assert recv.tolist() == [float((me - 1) % n)] * 5, recv

    def all_to_all_ring():
        # The ring rotation as the port issues it: each rank sends its block
        # to the next rank and receives the previous rank's.
        send = torch.full((5,), float(me), device=dev, dtype=dtype)
        recv = torch.empty(5, device=dev, dtype=dtype)
        dist.all_to_all_single(
            recv, send, output_split_sizes=[5 if j == (me - 1) % n else 0 for j in range(n)],
            input_split_sizes=[5 if j == (me + 1) % n else 0 for j in range(n)], group=group)
        assert recv.tolist() == [float((me - 1) % n)] * 5, recv

    def isend_irecv():
        nxt = dist.get_global_rank(group, (me + 1) % n)
        prv = dist.get_global_rank(group, (me - 1) % n)
        send = torch.full((5,), float(me), device=dev)
        recv = torch.empty(5, device=dev)
        reqs = [dist.isend(send, nxt, group=group), dist.irecv(recv, prv, group=group)]
        for r in reqs:
            r.wait()
        assert recv.tolist() == [float((me - 1) % n)] * 5, recv

    attempt(only, locals()[name])
    return out


OPS = ("all_reduce", "all_reduce_max", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single", "all_to_all_ring", "broadcast", "batch_isend_irecv",
       "isend_irecv", "mesh", "all_reduce_bf16", "all_gather_into_tensor_bf16",
       "reduce_scatter_tensor_bf16", "all_to_all_ring_bf16")


def rank_main(only, rank, world, store, out_path):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from torchdistx_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        if only == "mesh":
            try:
                mesh = make_mesh(MeshSpec(fsdp=2, tp=world // 2), device_type=DEVICE)
                results = _op(dist, torch, mesh.get_group("fsdp"), "mesh fsdp group",
                              "all_reduce")
            except Exception as e:
                results = {"mesh": f"{type(e).__name__}: {str(e).strip()[:200]}"}
        else:
            results = _op(dist, torch, dist.group.WORLD, "world", only)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "results": results}, f)


def _probe(only, world, root):
    """One operation in ``world`` fresh processes: its result line."""
    d = tempfile.mkdtemp(prefix=only, dir=root)
    outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", only,
                               str(r), str(world), os.path.join(d, "store"), outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        return f"{only}: a rank did not exit within {TIMEOUT_S} s (killed)"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        last = [line for log in logs for line in log.strip().splitlines()[-1:]]
        return f"{only}: ranks exited {codes}; {last[0][:300] if last else ''}"
    got = [json.load(open(o)) for o in outs]
    lines = []
    for key in got[0]["results"]:
        vals = sorted({g["results"].get(key, "missing") for g in got})
        lines.append(f"{key}: {' | '.join(vals)}")
    return "\n".join(lines)


def main():
    import torch

    world = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    root = tempfile.mkdtemp(prefix="tdx_gloo_probe_")
    print(f"torch {torch.__version__}, {world} gloo ranks on {DEVICE}, each operation in "
          "processes of its own")
    for only in sys.argv[2:] or OPS:
        print(_probe(only, world, root), flush=True)
    if DEVICE == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
        sys.exit(0)
    sys.exit(main())
