"""Spawned gloo process groups for the port's distributed tests
(test_torch_ring.py, test_torch_parallel.py).

:func:`run_group` starts ``world`` processes (spawn), each standing up
the default group through the port's ``rendezvous.initialize`` from the
driver's env contract (gloo, a port the OS picked), runs one worker
function of this module and saves its result; the parent joins them
with a deadline, kills what is left and raises on any failure, so a
deadlock fails one test instead of hanging the run.  The workers import
torch and the port only, never JAX: the tests compute JAX's references
in their own process and hand the workers numpy inputs.

Several checks run inside one group: a worker gets a list of cases and
returns one result per case, and :func:`jobs_worker` runs several
workers in turn.
"""

from __future__ import annotations

import multiprocessing as mp
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import torch

#: seconds a spawned group may take, start to join
GROUP_TIMEOUT_S = 180
#: the process group's own timeout (every collective), well inside it
PG_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out_dir):
    out = Path(out_dir)
    try:
        torch.set_num_threads(2)
        from k8s_dra_driver_tpu_torch.parallel import rendezvous
        env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPU_WORKER_ID": str(rank), "TPU_NUM_WORKERS": str(world),
               "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": str(PG_TIMEOUT_S)}
        rendezvous.initialize(rendezvous.spec_from_env(env),
                              backend="gloo")
        try:
            result = fn(rank, world, *args)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


class Group:
    """A spawned group in flight: :meth:`join` waits for it (deadline
    ``GROUP_TIMEOUT_S`` from the start) and returns the ranks' results
    in rank order, or raises with the failing ranks' tracebacks."""

    def __init__(self, fn, world: int, args, out_dir):
        self.world = world
        self.out = Path(out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        ctx = mp.get_context("spawn")
        port = free_port()
        self.procs = [ctx.Process(target=_entry, args=(
            r, world, port, fn, args, str(self.out))) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + GROUP_TIMEOUT_S

    def join(self) -> list:
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errs = {r: (self.out / f"rank{r}.err").read_text()
                for r in range(self.world)
                if (self.out / f"rank{r}.err").exists()}
        codes = [p.exitcode for p in self.procs]
        if hung or errs or any(codes):
            raise AssertionError(
                f"spawned group of {self.world} failed: hung ranks {hung}, "
                f"exit codes {codes}\n"
                + "\n".join(f"rank {r}:\n{e}" for r, e in errs.items()))
        return [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def run_group(fn, world: int, *args, out_dir) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks;
    returns the ranks' results in rank order."""
    return Group(fn, world, args, out_dir).join()


def shard(x, mesh):
    """This rank's shard of a global numpy array [B, T, ...]: batch rows
    by dp, the sequence by sp."""
    b, t = x.shape[0], x.shape[1]
    dp, sp = mesh.size("dp"), mesh.size("sp")
    bi, si = mesh.index("dp"), mesh.index("sp")
    return torch.from_numpy(np.ascontiguousarray(
        x[bi * b // dp:(bi + 1) * b // dp, si * t // sp:(si + 1) * t // sp]))


def unshard(parts: list, coords: list) -> np.ndarray:
    """The global array from the ranks' shards, each placed at its
    rank's ``coords`` ({"dp": i, "sp": j, ...})."""
    dp = 1 + max(c["dp"] for c in coords)
    sp = 1 + max(c["sp"] for c in coords)
    grid = [[None] * sp for _ in range(dp)]
    for part, c in zip(parts, coords):
        grid[c["dp"]][c["sp"]] = np.asarray(part)
    return np.concatenate([np.concatenate(row, axis=1) for row in grid],
                          axis=0)


# --------------------------------------------------------------------------
# Workers
# --------------------------------------------------------------------------

def attention_worker(rank, world, cases):
    """Ring or Ulysses attention on each case's mesh: this rank's output
    and the gradients of sum(out * g) in q, k and v."""
    from k8s_dra_driver_tpu_torch.ops.ring_attention import ring_attention
    from k8s_dra_driver_tpu_torch.ops.ulysses_attention import (
        ulysses_attention)
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    meshes, results = {}, []
    for c in cases:
        spec = MeshSpec(**c["spec"])
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device="cpu")
        mesh = meshes[spec]
        q, k, v = (shard(x, mesh).requires_grad_() for x in c["qkv"])
        g = shard(c["g"], mesh)
        seg = None if c["seg"] is None else shard(c["seg"], mesh)
        attend = (ulysses_attention if c["method"] == "ulysses"
                  else ring_attention)
        out = attend(q, k, v, mesh, causal=c["causal"],
                     window=c["window"], segment_ids=seg)
        (out * g).sum().backward()
        results.append(dict(coords=mesh.coords, out=out.detach().numpy(),
                            dq=q.grad.numpy(), dk=k.grad.numpy(),
                            dv=v.grad.numpy()))
    return results


def model_worker(rank, world, cases):
    """The transformer's mesh path on each case: ``forward`` logits of
    this rank's shard, or the losses of ``make_train_step`` steps on
    global batches (every rank the same batch), plus the parameters
    after the steps on rank 0."""
    from k8s_dra_driver_tpu_torch.models import transformer as tt
    from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    meshes, results = {}, []
    for c in cases:
        spec = MeshSpec(**c["spec"])
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device="cpu")
        mesh = meshes[spec]
        cfg = tt.TransformerConfig(**c["cfg"])
        params = params_from_jax(c["params"], device="cpu")
        seg = c.get("seg")
        if c["kind"] == "forward":
            with torch.no_grad():
                logits = tt.forward(params, shard(c["tokens"], mesh), cfg,
                                    None if seg is None
                                    else shard(seg, mesh), mesh=mesh)
            results.append(dict(coords=mesh.coords,
                                logits=logits.numpy()))
            continue
        step, _ = tt.make_train_step(cfg, device="cpu", mesh=mesh)
        leaves = [t.requires_grad_() for _, t in tt.named_tensors(params)]
        opt = tt.make_optimizer()(leaves)
        losses = []
        for i, toks in enumerate(c["tokens"]):
            segs = None if seg is None else seg[i]
            params, opt, loss = step(params, opt, toks, segs)
            losses.append(float(loss))
        results.append(dict(
            coords=mesh.coords, losses=losses,
            params={n: t.detach().numpy()
                    for n, t in tt.named_tensors(params)}))
    return results


def contract_worker(rank, world):
    """The rendezvous' liveness psum, and what ``make_mesh`` refuses on
    this group: (exception type, message) per refused spec, or None."""
    from k8s_dra_driver_tpu_torch.parallel import rendezvous
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    out = {"psum": rendezvous.gang_psum(float(rank + 1))}
    for name, spec in (("mismatch", MeshSpec(dp=world + 1)),
                       ("tp", MeshSpec(tp=world)),
                       ("ep", MeshSpec(ep=world)),
                       ("pp", MeshSpec(pp=world))):
        try:
            make_mesh(spec, device="cpu")
            out[name] = None
        except Exception as e:    # recorded for the test to judge
            out[name] = (type(e).__name__, str(e))
    mesh = make_mesh(device="cpu")
    out["default"] = (mesh.spec.axis_sizes(), mesh.coords)
    return out


def jobs_worker(rank, world, jobs):
    """``[(worker, args), ...]`` run in turn on one group."""
    return [fn(rank, world, *args) for fn, args in jobs]


def as_global_worker(rank, world, batch):
    """``models/data.as_global`` over a dp mesh of the world: each rank
    hands in its ``local_rows`` stripe of ``batch`` and gets the global
    batch back."""
    from k8s_dra_driver_tpu_torch.models.data import as_global, local_rows
    from k8s_dra_driver_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device="cpu")
    return as_global(local_rows(batch), mesh).numpy()
