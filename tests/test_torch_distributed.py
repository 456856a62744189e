"""The port's multi-process start-up (dbat_tpu_torch/parallel/
distributed.py), mirroring tests/test_distributed.py with torch's
environment names: the single-process no-op, the environment parsing
(init_process_group stubbed: a real one would wait for its peers), the
global mesh of one process, and a real two-process run on the CPU with
the gloo backend whose sharded Gauss-Newton step agrees with the
unsharded SchurOps (1e-8, the JAX test's bound) and with the same two
shards in one process (1e-12: the same additions in the same order;
it comes out bitwise equal), then a PCG step of the legacy mesh path
(SchurOps(mesh=), observation shards) on the same two processes: 1e-12
of its in-process run, 1e-6 of the unsharded direct step (PCG stops
at 1e-10 of its residual)."""

import os
import re
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from dbat_tpu_torch.parallel import distributed

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_single_process_is_noop(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    assert distributed._initialized is False


def test_env_parsing_routes_to_init_process_group(monkeypatch):
    calls = []

    def fake_init(backend, init_method=None, world_size=None, rank=None):
        calls.append(dict(backend=backend, init_method=init_method,
                          world_size=world_size, rank=rank))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setattr(distributed, "_initialized", False)
    try:
        assert distributed.init_distributed() is True
        assert calls == [dict(backend="gloo",
                              init_method="tcp://10.0.0.1:1234",
                              world_size=4, rank=2)]
        # A second call is a no-op returning True.
        assert distributed.init_distributed() is True
        assert len(calls) == 1
        # Explicit arguments win over the environment.
        monkeypatch.setattr(distributed, "_initialized", False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert distributed.init_distributed("localhost:99", 2, 1) is True
        assert calls[1] == dict(backend="cpu:gloo,cuda:nccl",
                                init_method="tcp://localhost:99",
                                world_size=2, rank=1)
    finally:
        monkeypatch.setattr(distributed, "_initialized", False)


def test_global_mesh_of_one_process(monkeypatch):
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),)
    assert mesh.axis_names == ("obs",) and mesh.group is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.global_mesh()


WORKER = r'''
import sys
sys.path.insert(0, __REPO__)
import numpy as np
import torch
torch.set_num_threads(1)
pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from dbat_tpu_torch.parallel.distributed import init_distributed, global_mesh
assert init_distributed(coordinator_address="localhost:" + port,
                        num_processes=n, process_id=pid)
mesh = global_mesh(device="cpu")
assert mesh.n_shards == n and mesh.owned == (pid,)
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.parallel.mesh import make_mesh
from dbat_tpu_torch.parallel.sharded import ShardedSchurOps
from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb
from dbat_tpu_torch.solve.schur import SchurOps

def net():
    s = make_ring_network(n_img=8, n_pt=120, rays_per_pt=(3, 5),
                          n_ctrl=6, noise_px=0.1, ip_std_px=0.1, seed=7)
    perturb(s, eo_pos=0.01, eo_ang=0.002, op_pos=0.01, seed=8)
    return s

def step(ops):
    st = ops.normal(ops.x0())
    p, failed = st.solve(-st.g)
    assert not failed
    return p.numpy(), float(st.rw @ st.rw)

s = net()
p, f = step(ShardedSchurOps(s, build_serial(s), mesh=mesh))
s1 = net()
p1, _ = step(ShardedSchurOps(s1, build_serial(s1),
                             mesh=make_mesh(["cpu"] * n)))
s2 = net()
p2, _ = step(SchurOps(s2, build_serial(s2), device="cpu"))
dev1 = float(np.max(np.abs(p - p1)))
dev2 = float(np.max(np.abs(p - p2)))
print(f"GNSTEP_DEV in-process {dev1:.3e} unsharded {dev2:.3e} f {f!r}",
      flush=True)
assert dev1 <= 1e-12 and dev2 < 1e-8

# The legacy mesh path (observation shards, pair chunks, PCG): its
# per-observation rows all-gather across the processes.
def pcg_step(ops):
    x0 = ops.x0()
    U, V, Wb, gc, gp, _rw = ops._assemble_impl(x0)
    p, (iters, rel) = ops._solve_pcg_impl(U, V, Wb, -ops.join_x(gc, gp),
                                          0.0)
    assert rel <= 1e-10
    return p.numpy(), float(ops.weighted_residual(x0) @
                            ops.weighted_residual(x0))

s3, s4 = net(), net()
q, fq = pcg_step(SchurOps(s3, build_serial(s3), mesh=mesh, pair_chunk=64))
q1, fq1 = pcg_step(SchurOps(s4, build_serial(s4),
                            mesh=make_mesh(["cpu"] * n), pair_chunk=64))
dev3 = float(np.max(np.abs(q - q1)))
dev4 = float(np.max(np.abs(q - p2)))
print(f"LEGACY_DEV in-process {dev3:.3e} unsharded {dev4:.3e} f {fq!r}",
      flush=True)
assert dev3 <= 1e-12 and dev4 < 1e-6 and fq == fq1
assert abs(fq / f - 1) < 1e-12
torch.distributed.destroy_process_group()
'''


def test_two_process_gn_step(tmp_path):
    """Two processes on localhost with gloo: init_distributed, a mesh of
    one shard per process, and one sharded Gauss-Newton step whose shard
    sums all-gather across the processes; then a PCG step on the legacy
    mesh path (SchurOps(mesh=)) over the same mesh."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    worker = tmp_path / "worker.py"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker.write_text(WORKER.replace("__REPO__", repr(repo)))
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "GNSTEP_DEV" in out and "LEGACY_DEV" in out
    # Both processes hold the same replicated results.
    for key in ("GNSTEP_DEV", "LEGACY_DEV"):
        lines = [re.search(key + r" .*", out).group(0) for out in outs]
        assert lines[0] == lines[1]
