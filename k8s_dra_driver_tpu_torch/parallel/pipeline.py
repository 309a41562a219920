"""GPipe-style pipeline parallelism over a ``pp`` mesh axis.

The port of ``k8s_dra_driver_tpu/parallel/pipeline.py``: ``stack_stages``,
``split_layers`` and ``pipeline_apply`` with the JAX package's
``ValueError`` messages.  Each pp rank of the process mesh
(parallel/mesh.py) is one stage and holds that stage's parameters.

The schedule is GPipe's ``n_microbatches + S - 1`` ticks: at tick t
stage i applies its layers to microbatch ``t - i``, stage 0 taking it
from the input and every later stage receiving it from stage i - 1.
JAX computes the fill and drain ticks on zeros (its shapes are static)
and masks their outputs off; the port skips them, since no output
depends on them, so a stage runs its layers once a microbatch.  The
last stage's outputs are broadcast to every pp rank (JAX's masked
``psum``), where the model tail runs.

The backward schedule is written out rather than left to autograd,
whose traversal order over sends and receives would not pair up
across processes: the whole pipeline is one ``torch.autograd.Function``
whose backward walks the microbatches in the forward's order, each
stage receiving the output gradient from stage i + 1 (the last stage
takes its own), running its layers' backward, and sending the input
gradient to stage i - 1.  ``checkpoint_stages`` keeps only each
microbatch's stage input and recomputes the stage in the backward (the
counterpart of ``jax.checkpoint`` around the stage body); without it a
stage keeps each microbatch's graph from the forward.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint


def stack_stages(per_stage_params: list):
    """[S] list of identically-structured trees (dicts and lists of
    tensors) -> one tree whose leaves lead with the stage axis."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stages([p[k] for p in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stages([p[i] for p in per_stage_params])
                           for i in range(len(first)))
    return torch.stack(list(per_stage_params))


class _Pipeline(torch.autograd.Function):
    """The GPipe forward and its explicit backward (module docstring).
    Inputs: ``x`` and this stage's parameter leaves; output: the last
    stage's output for the whole batch, on every pp rank."""

    @staticmethod
    def forward(ctx, x, run, n_micro, mesh, axis, checkpoint, *leaves):
        s, idx = mesh.size(axis), mesh.index(axis)
        x_grad = ctx.needs_input_grad[0]
        want = ctx.needs_input_grad[6:]
        mbs = x.chunk(n_micro, dim=0)
        shape, dtype = mbs[0].shape, x.dtype
        saved, outs = [], []
        for m in range(n_micro):
            inp = mbs[m] if idx == 0 else mesh.recv(shape, dtype, axis,
                                                     idx - 1)
            inp = inp.detach()
            if checkpoint:
                y = run(inp, leaves)
                saved.append((inp, None))
            else:
                live = [t.detach().requires_grad_(w)
                        for t, w in zip(leaves, want)]
                inp = inp.requires_grad_(x_grad or idx > 0)
                with torch.enable_grad():
                    y = run(inp, live)
                saved.append((inp, (y, live)))
                y = y.detach()
            if idx < s - 1:
                mesh.send(y, axis, idx + 1)
            else:
                outs.append(y)
        out = (torch.cat(outs) if idx == s - 1
               else torch.empty_like(x))
        ctx.run, ctx.n_micro, ctx.mesh, ctx.axis = run, n_micro, mesh, axis
        ctx.saved, ctx.leaves, ctx.shape = saved, leaves, shape
        ctx.x_grad, ctx.want = x_grad, want
        return mesh.broadcast(out, axis, s - 1)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, leaves = ctx.mesh, ctx.axis, ctx.leaves
        s, idx = mesh.size(axis), mesh.index(axis)
        g_mbs = g.chunk(ctx.n_micro, dim=0)
        grads = [None] * len(leaves)
        gx = []
        for m in range(ctx.n_micro):
            gy = (g_mbs[m] if idx == s - 1
                  else mesh.recv(ctx.shape, g.dtype, axis, idx + 1))
            inp, graph = ctx.saved[m]
            if graph is None:
                live = [t.detach().requires_grad_(w)
                        for t, w in zip(leaves, ctx.want)]
                inp = inp.detach().requires_grad_(ctx.x_grad or idx > 0)
                with torch.enable_grad():
                    y = ctx.run(inp, live)
            else:
                y, live = graph
            wrt = [t for t in live if t.requires_grad]
            if inp.requires_grad:
                wrt = [inp] + wrt
            got = list(torch.autograd.grad(y, wrt, gy, allow_unused=True))
            g_in = got.pop(0) if inp.requires_grad else None
            if idx > 0:
                mesh.send(g_in if g_in is not None
                          else torch.zeros_like(inp), axis, idx - 1)
            elif ctx.x_grad:
                gx.append(g_in if g_in is not None
                          else torch.zeros_like(inp))
            it = iter(got)
            for i, t in enumerate(live):
                if not t.requires_grad:
                    continue
                d = next(it)
                if d is not None:
                    grads[i] = d if grads[i] is None else grads[i] + d
        ctx.saved = None
        if not ctx.x_grad:
            dx = None
        elif idx == 0:
            dx = torch.cat(gx)
        else:
            dx = torch.zeros_like(g)
        return (dx, None, None, None, None, None, *grads)


def pipeline_apply(stage_fn, stage_params, x, *, mesh, n_microbatches: int,
                   axis: str = "pp", checkpoint_stages: bool = True):
    """Run ``x`` through ``S = mesh.size(axis)`` pipelined stages.

    ``stage_fn(params_slice, x_mb) -> y_mb`` must preserve the
    microbatch's shape and dtype; ``x`` is this rank's batch-leading
    input, the same on every rank of the pp line, and its batch must
    divide into ``n_microbatches``.  ``stage_params`` leaves lead with
    the stage axis: either all S stages (this rank takes its own) or
    this stage's block of 1, as ``models/transformer.py``'s
    ``shard_params`` places them.  Returns the final stage's output for
    the whole batch, in order, on every pp rank; differentiable in
    ``x`` and the parameters."""
    n_stages = mesh.size(axis)
    batch = x.shape[0]
    if n_microbatches < 1:
        raise ValueError("need at least one microbatch")
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible into "
                         f"{n_microbatches} microbatches")
    from .resharding import tree_flatten_with_path, tree_map
    paths, leaves = zip(*tree_flatten_with_path(stage_params))
    sizes = {int(t.shape[0]) for t in leaves}
    if sizes not in ({n_stages}, {1}):
        raise ValueError(
            f"stage_params leaves must lead with the stage axis "
            f"{n_stages} (or 1, this rank's stage), got leading sizes "
            f"{sorted(sizes)}")
    at = mesh.index(axis) if sizes == {n_stages} else 0
    mine = [t[at:at + 1] for t in leaves] if n_stages > 1 or at else leaves

    def run(inp, live):
        at_path = {p: t[0] for p, t in zip(paths, live)}
        return stage_fn(tree_map(lambda p, _: at_path[p], stage_params), inp)

    if n_stages == 1:
        # one stage: no schedule, no exchange
        return torch.cat([
            torch.utils.checkpoint.checkpoint(run, mb, mine,
                                              use_reentrant=False)
            if checkpoint_stages else run(mb, mine)
            for mb in x.chunk(n_microbatches, dim=0)])
    return _Pipeline.apply(x, run, n_microbatches, mesh, axis,
                           checkpoint_stages, *mine)


def split_layers(n_layers: int, n_stages: int) -> int:
    """Layers per stage; n_layers must divide evenly."""
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers do not split into {n_stages} stages")
    return n_layers // n_stages


__all__ = ["pipeline_apply", "split_layers", "stack_stages"]
