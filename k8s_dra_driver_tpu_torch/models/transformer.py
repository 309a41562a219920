"""Decoder-only transformer: config, parameters, the forward pass and
the training step.

The port of ``k8s_dra_driver_tpu/models/transformer.py`` for dense
and MoE configs on one device and over any dp x ep x sp x tp x pp
process mesh (``parallel/mesh.py``).  Parameters keep the JAX package's
layout and key names — ``wq [d,h,dh]``, ``wk/wv [d,h_kv,dh]``, ``wo
[h,dh,d]``, ``w_in [d,f]``, ``w_out [f,d]`` (MoE: ``router [d,E]``,
``w_in [E,d,f]``, ``w_out [E,f,d]``), ``embed [V,d]``, ``unembed
[d,V]``, ``ln1/ln2/ln_f [d]`` in a dict with a ``layers`` list — so
the same einsum specs apply and ``models/convert.py`` moves a JAX
checkpoint over key for key.

Numerics follow the reference where PyTorch's defaults differ: GELU is
the tanh approximation (``jax.nn.gelu``'s default), RoPE rotates
interleaved pairs, RMSNorm takes its variance in f32 and multiplies in
x's dtype.

Sparse MoE: a softmax router with top-k zeroing, the router aux
losses, and the three dispatch strategies of ``moe_dispatch``:
"dense" (every expert on every token), "capacity" (GShard one-hot
dispatch with a per-expert budget) and "gmm" (dropless: tokens sorted
by expert through the grouped-matmul kernels K5/K6 on the card,
ops/gmm.py).

Training: ``loss_fn`` (next-token NLL, f32 logits, segment keep-mask,
router aux losses), ``make_optimizer`` (AdamW, optax's defaults) and
``make_train_step``.  The step updates the parameters and the optimizer
state in place (where JAX donates its buffers); gradients reach every
weight, the attention projections through the flash backward kernels
K3/K4 and the experts through K5/K6 on the card.

The mesh path (``mesh=`` on :func:`forward`, :func:`loss_fn` and
:func:`make_train_step`): each rank holds its ``B/(dp ep) x T/sp``
shard of the batch and its block of each parameter, cut by the layout
table (models/layouts.py, :func:`param_specs`, :func:`shard_params`).
Where JAX's compiler places the collectives a layout needs, the port
writes them (parallel/mesh.py's differentiable wrappers):

- tp: each rank runs its ``H/tp`` query and KV heads (K1, K3/K4 on
  them) and its ``d_ff/tp`` hidden units; the attention and MLP inputs
  enter through ``copy_to`` and their partial outputs leave through
  ``reduce_from``; the embedding looks up its d-slice and all-gathers
  it, the unembedding sums its partial logits.
- ep: each rank all-gathers the ep part of the batch, runs every
  gathered token against its local experts (gmm: non-local picks go to
  a zero-weight dead group, so K5/K6 run per shard over ``E/ep + 1``
  groups; dense and capacity: the local experts' slice of the gates),
  sums over tp and reduce-scatters back over ep.
- sp: ring (K1's block entry forward, K3/K4 backward) or Ulysses (the
  normalized K1, K3/K4) attention by ``cfg.seq_parallel`` over the
  local heads, rotary positions from the shard's absolute start.
- pp: staged parameters (``stages/<name>`` leaves ``[S, L/S, ...]``,
  this rank's stage a block of 1) run through GPipe
  (parallel/pipeline.py); the embedding and the tail run on every pp
  rank.

The loss is the JAX package's global mean (sums over the batch axes dp,
ep and sp only: tp and pp ranks hold copies), and the step sums each
leaf's gradient over the batch axes its spec does not name (and
``embed``'s over pp, where stage 0 alone feeds it) before every rank's
AdamW step on its own blocks.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.gmm import _round_up, gmm, pick_gmm_blocks
from ..ops.ring_attention import attention_reference, ring_attention
from ..ops.ulysses_attention import ulysses_attention
from ..parallel.mesh import (P, all_gather_ad, copy_to, gather_replicated,
                             reduce_from, reduce_scatter_ad, spec_axes,
                             spec_block)
from ..parallel.resharding import (leaf_name, match_partition_rules,
                                   tree_flatten_with_path, tree_map)
from ..utils.device import resolve_device
from .quant import QTensor, ein, scale_dims, take_rows

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields, defaults and validation as the JAX
    ``TransformerConfig``; ``dtype`` is a torch dtype."""

    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_head: int = 64
    d_ff: int = 2048
    n_experts: int = 0          # 0 = dense MLP
    top_k: int = 2
    max_seq: int = 2048
    dtype: Any = torch.bfloat16
    remat: bool = False
    seq_parallel: str = "ring"
    n_kv_heads: int = 0
    attention_window: int = 0
    moe_dispatch: str = "dense"
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.0
    router_z_weight: float = 0.0
    kv_cache_dtype: str = "model"
    rope_theta: float = 10000.0
    pp_stages: int = 1
    pp_microbatches: int = 0

    def __post_init__(self):
        if self.seq_parallel not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown seq_parallel {self.seq_parallel!r}; "
                "choose 'ring' or 'ulysses'")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not a multiple of "
                f"n_kv_heads {self.n_kv_heads}")
        if self.attention_window < 0:
            raise ValueError("attention_window must be >= 0")
        if self.moe_dispatch not in ("dense", "capacity", "gmm"):
            raise ValueError(
                f"unknown moe_dispatch {self.moe_dispatch!r}; "
                "choose 'dense', 'capacity' or 'gmm'")
        if self.capacity_factor <= 0:
            raise ValueError("capacity_factor must be > 0")
        if self.aux_loss_weight < 0 or self.router_z_weight < 0:
            raise ValueError("router aux-loss weights must be >= 0")
        if self.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"unknown kv_cache_dtype {self.kv_cache_dtype!r}; "
                "choose 'model' or 'int8'")
        if self.pp_stages < 1 or self.pp_microbatches < 0:
            raise ValueError("pp_stages must be >= 1 and "
                             "pp_microbatches >= 0")
        if self.pp_stages > 1:
            if self.n_layers % self.pp_stages:
                raise ValueError(
                    f"n_layers {self.n_layers} does not split into "
                    f"{self.pp_stages} pipeline stages")
            if self.aux_loss_weight or self.router_z_weight:
                raise ValueError(
                    "pp_stages > 1 does not support the router aux "
                    "losses (stage outputs carry activations only)")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    shapes = {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, h, dh), "wk": (d, cfg.kv_heads, dh),
        "wv": (d, cfg.kv_heads, dh),
        "wo": (h, dh, d),
    }
    if cfg.is_moe:
        shapes.update({
            "router": (d, cfg.n_experts),
            "w_in": (cfg.n_experts, d, f),
            "w_out": (cfg.n_experts, f, d),
        })
    else:
        shapes.update({"w_in": (d, f), "w_out": (f, d)})
    return shapes


def init_params(cfg: TransformerConfig,
                generator: torch.Generator | None = None,
                device="cuda") -> Params:
    """Random parameters in the JAX layout: normal(0, fan_in^-1/2)
    matrices, ones for the norms.  Values are drawn in f32 on
    ``generator``'s device (default: a CPU generator seeded 0) and
    cast to ``cfg.dtype`` on ``device``; they do not match JAX's.

    ``fan_in`` is each matrix's contraction size (``d_model`` for
    wq/wk/wv/w_in/router, ``h * d_head`` for wo, ``d_ff`` for w_out;
    for the MoE experts these equal JAX's ``shape[-2]``).  The JAX
    package takes the second-to-last dim instead, which for the 3-D
    attention weights is a head count: its q and k come out with
    standard deviations near 8 and 16 at the 154M shape, attention is
    nearly one-hot, and two bf16 evaluations of one prefix can then
    differ by whole logits.  With the contraction size, bf16 decode and
    the full forward agree closely enough to check one against the
    other.  The layers come as a list for every config;
    :func:`shard_params` stages a pp config's."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": h * dh, "w_in": d,
              "w_out": cfg.d_ff, "router": d}

    def dense(shape, fan):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * (fan ** -0.5)
        return x.to(device=dev, dtype=cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    params: Params = {
        "embed": dense((cfg.vocab, d), d),
        "unembed": dense((d, cfg.vocab), d),
        "ln_f": ones((d,)),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {}
        for name, shape in _layer_shapes(cfg).items():
            layer[name] = (ones(shape) if name.startswith("ln")
                           else dense(shape, fan_in[name]))
        params["layers"].append(layer)
    return params


def _param_skeleton(cfg: TransformerConfig) -> Params:
    """The tree of :func:`init_params` (staged as :func:`stage_params`
    stages it when ``pp_stages > 1``) over shape-only meta tensors:
    what the layout table matches against."""
    def meta(shape):
        return torch.empty(tuple(shape), dtype=cfg.dtype, device="meta")

    head: Params = {
        "embed": meta((cfg.vocab, cfg.d_model)),
        "unembed": meta((cfg.d_model, cfg.vocab)),
        "ln_f": meta((cfg.d_model,)),
    }
    shapes = _layer_shapes(cfg)
    if cfg.pp_stages > 1:
        from ..parallel.pipeline import split_layers
        lps = split_layers(cfg.n_layers, cfg.pp_stages)
        head["stages"] = {name: meta((cfg.pp_stages, lps) + shape)
                          for name, shape in shapes.items()}
        return head
    head["layers"] = [{name: meta(shape) for name, shape in shapes.items()}
                      for _ in range(cfg.n_layers)]
    return head


def param_specs(cfg: TransformerConfig) -> Params:
    """Per-leaf ``PartitionSpec``s from the model's rule table
    (models/layouts.py) matched over the shape skeleton: one table lays
    the model out on any dp x ep x sp x tp x pp mesh."""
    from .layouts import transformer_rules
    return match_partition_rules(transformer_rules(cfg),
                                 _param_skeleton(cfg))


def stage_params(params: Params, cfg: TransformerConfig) -> Params:
    """layers-list params -> the staged layout for pipeline parallelism:
    ``params["stages"]`` leaves lead with ``[S, L/S, ...]``.  Inverse:
    :func:`unstage_params`."""
    from ..parallel.pipeline import split_layers
    lps = split_layers(cfg.n_layers, cfg.pp_stages)
    layers = params["layers"]
    stages = {name: torch.stack([
        torch.stack([layers[s * lps + i][name] for i in range(lps)])
        for s in range(cfg.pp_stages)]) for name in layers[0]}
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stages"] = stages
    return out


def unstage_params(params: Params, cfg: TransformerConfig) -> Params:
    """Staged layout -> layers list (to run the sequential path, serve,
    or restore onto a pp-less mesh).  The layers are views of the
    staged leaves."""
    from ..parallel.pipeline import split_layers
    lps = split_layers(cfg.n_layers, cfg.pp_stages)
    layers = [{name: a[s, i] for name, a in params["stages"].items()}
              for s in range(cfg.pp_stages) for i in range(lps)]
    out = {k: v for k, v in params.items() if k != "stages"}
    out["layers"] = layers
    return out


def _map_with_specs(fn, params: Params, cfg: TransformerConfig) -> Params:
    """``params`` (in the layout of :func:`param_specs`) with every leaf
    replaced by ``fn(leaf, its spec)``.  A ``QTensor`` leaf (int8
    weights, models/quant.py) maps its values by the leaf's spec and its
    scale by the same spec with the dims its quantization reduced to 1
    (``quant.scale_dims``) left whole."""
    specs = dict(tree_flatten_with_path(param_specs(cfg)))

    def one(path, x):
        spec = specs[path]
        if not isinstance(x, QTensor):
            return fn(x, spec)
        reduced = scale_dims(path[-1], cfg.is_moe)
        # layout: the leaf's own rule (layouts.py), its scale's size-1
        # dims left whole
        whole = P(*(None if dim in reduced else entry
                    for dim, entry in enumerate(tuple(spec))))
        return QTensor(q=fn(x.q, spec), scale=fn(x.scale, whole))
    return tree_map(one, params)


def shard_params(params: Params, cfg: TransformerConfig, mesh) -> Params:
    """This rank's block of every leaf of whole ``params`` (staged first
    for a pp config), cut by :func:`param_specs` and the rank's mesh
    coordinates: fresh contiguous tensors, the counterpart of JAX's
    ``device_put`` onto the mesh.  ``quantize_params`` output is cut
    leaf by leaf (:func:`_map_with_specs`): each rank's scales are then
    those of JAX's ``quantize_params(shard_params(p))``, whose GSPMD
    amax runs over the whole contracted axis."""
    if cfg.pp_stages > 1 and "layers" in params:
        params = stage_params(params, cfg)   # pp wants staged residency
    sizes, coords = mesh.spec.axis_sizes(), mesh.coords

    def cut(x, spec):
        bounds = spec_block(x.shape, spec, sizes, coords)
        for dim, (lo, hi) in enumerate(bounds):
            x = x.narrow(dim, lo, hi - lo)
        return x.detach().clone()
    return _map_with_specs(cut, params, cfg)


def grad_tree(params: Params) -> Params:
    """``params``' tree with each leaf's gradient in its place."""
    return tree_map(lambda _, x: x.grad, params)


def gather_params(params: Params, cfg: TransformerConfig, mesh) -> Params:
    """The inverse of :func:`shard_params`: every rank's blocks of a
    tree in the sharded layout (parameters, or their gradients) gathered
    into whole tensors on every rank (``QTensor`` leaves with their
    scales).  Collective over the mesh."""
    def whole(x, spec):
        x = x.detach()
        for dim, entry in enumerate(tuple(spec)):
            for axis in reversed(spec_axes(entry)):
                x = mesh.all_gather(x.contiguous(), axis, dim)
        return x
    return _map_with_specs(whole, params, cfg)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def rms_norm(x, weight, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * weight


def rotary(x, positions, theta: float = 10000.0):
    """Rotary position embedding on interleaved pairs; x [B,T,H,D],
    positions [T] (shared across the batch) or [B,T] (per-row, as in
    continuous-batching decode).  ``theta`` is the RoPE base."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].to(torch.float32) * freqs
    if positions.ndim == 1:
        angles = angles[None]                      # [1, T, F]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def _attention(x, layer, cfg: TransformerConfig, segment_ids=None,
               mesh=None):
    """Attention of one layer over this rank's heads (all of them, or
    its ``H/tp`` with its block of wq/wk/wv/wo under tp: the input
    enters by ``copy_to`` and the partial output leaves by
    ``reduce_from``).  With a mesh whose sp axis is > 1 (the JAX
    ``transformer.py:354-364`` branch): ring or Ulysses attention by
    ``cfg.seq_parallel`` over this rank's sequence shard, rotary
    positions from the shard's absolute start.  Otherwise flash
    attention on the card (K1 forward, K3/K4 backward), the dense
    oracle elsewhere — the split ``transformer.py:365-374`` makes
    between the TPU and other backends."""
    x = copy_to(x, mesh, "tp")
    b, t, d = x.shape
    sp = mesh.size("sp") if mesh is not None else 1
    start = mesh.index("sp") * t if sp > 1 else 0
    positions = torch.arange(start, start + t, device=x.device)
    q = rotary(ein("btd,dhk->bthk", x, layer["wq"]), positions,
               cfg.rope_theta)
    k = rotary(ein("btd,dhk->bthk", x, layer["wk"]), positions,
               cfg.rope_theta)
    v = ein("btd,dhk->bthk", x, layer["wv"])
    window = cfg.attention_window or None
    seg = (segment_ids.to(torch.int32).contiguous()
           if segment_ids is not None else None)
    if sp > 1:
        attend = (ulysses_attention if cfg.seq_parallel == "ulysses"
                  else ring_attention)
        o = attend(q, k, v, mesh, causal=True, window=window,
                   segment_ids=seg)
    elif x.device.type == "cuda":
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=window, segment_ids=seg)
    else:
        o = attention_reference(q, k, v, causal=True, window=window,
                                segment_ids=segment_ids).to(x.dtype)
    return reduce_from(ein("bthk,hkd->btd", o, layer["wo"]), mesh, "tp")


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _dense_mlp(x, layer, mesh=None):
    """The dense MLP over this rank's ``d_ff/tp`` hidden units under tp
    (w_in ``P(None, "tp")``, w_out ``P("tp", None)``).  Decoding
    (models/decode.py) calls it, :func:`_embed` and :func:`_unembed`
    forward-only: the collectives' autograd wrappers then record
    nothing, and without a mesh each is its single-process op."""
    x = copy_to(x, mesh, "tp")
    h = _gelu(ein("btd,df->btf", x, layer["w_in"]))
    return reduce_from(ein("btf,fd->btd", h, layer["w_out"]), mesh, "tp")


def _router_gates(x, layer, cfg: TransformerConfig):
    """Softmax router with top-k zeroing + renormalization.

    Returns ``(gates, probs, logits)``, all f32 [B, T, E]: gates are
    zero on unselected experts (every expert tied with the k-th value
    is kept, as ``>=`` keeps it in the JAX package); probs are the full
    softmax, for the load-balance loss; logits feed the z-loss."""
    logits = torch.einsum("btd,de->bte", x, layer["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates = probs
    if cfg.top_k < cfg.n_experts:
        top = torch.topk(gates, cfg.top_k, dim=-1).values[..., -1:]
        gates = torch.where(gates >= top, gates, 0.0)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, probs, logits


def _batch_axes(mesh) -> list[str]:
    """The mesh axes of size > 1 that split the batch or the sequence:
    the axes a token sum runs over."""
    return [a for a in ("dp", "ep", "sp") if mesh.size(a) > 1]


def _token_sum(x, mesh):
    """``x`` summed over every token of the global batch: this rank's
    sums added over the batch axes (identity backward: each rank's
    gradient reaches its own tokens)."""
    if mesh is not None:
        for axis in _batch_axes(mesh):
            x = reduce_from(x, mesh, axis)
    return x


def _moe_aux(gates, probs, logits, cfg: TransformerConfig, mesh=None):
    """Router auxiliary objectives of one layer, f32 scalars: the
    load balance ``E * sum_e assignment_fraction_e * mean_prob_e``
    (Switch Transformer, generalized to top-k; 1 at uniform routing)
    and the z-loss ``mean(logsumexp(logits)^2)``, the means over the
    global batch (over the mesh's batch axes with a mesh).  Every rank
    holds an equal shard (``ProcessMesh.local_batch``), so the global
    token count is the local one times the batch axes' sizes."""
    n = gates.shape[0] * gates.shape[1]
    if mesh is not None:
        n *= math.prod(mesh.size(a) for a in _batch_axes(mesh))
    sel = (gates > 0.0).float()
    frac = _token_sum(sel.sum(dim=(0, 1)), mesh) / n / max(cfg.top_k, 1)
    mean_prob = _token_sum(probs.sum(dim=(0, 1)), mesh) / n
    load = cfg.n_experts * torch.sum(frac * mean_prob)
    z = _token_sum((torch.logsumexp(logits, dim=-1) ** 2).sum(), mesh) / n
    return load, z


def _moe_capacity(cfg: TransformerConfig, t: int) -> int:
    cap = int(cfg.capacity_factor * cfg.top_k * t / cfg.n_experts)
    return max(min(cap, t), 1)


def _moe_mlp_capacity(x, gates, layer, cfg: TransformerConfig):
    """GShard-style capacity dispatch: each token goes to a position
    inside its experts' budget C (position-in-expert by a cumsum in
    sequence order), the expert products run on [E, B, C, d], and
    tokens past an expert's budget drop that expert's contribution
    (their other picks still apply).

    ``jax.nn.one_hot`` gives a zero row for an out-of-range index (-1
    for an unselected expert, >= C past the budget) where
    ``F.one_hot`` raises, so the one-hot is the same comparison with
    ``arange(C)`` that ``jax.nn.one_hot`` makes, masked by ``keep``."""
    b, t, d = x.shape
    cap = _moe_capacity(cfg, t)
    sel = gates > 0.0
    pos = torch.cumsum(sel.to(torch.int32), dim=1) - 1      # [b,t,e]
    keep = sel & (pos < cap)
    slots = torch.arange(cap, device=x.device)
    onehot = ((pos[..., None] == slots) & keep[..., None]).to(x.dtype)
    combine = gates[..., None].to(x.dtype) * onehot          # [b,t,e,c]
    expert_in = torch.einsum("btec,btd->becd", onehot, x)
    h = _gelu(ein("becd,edf->becf", expert_in, layer["w_in"]))
    y = ein("becf,efd->becd", h, layer["w_out"])
    return torch.einsum("btec,becd->btd", combine, y)


def _gmm_block_m(rows: int, w_in) -> int:
    """Row-block size for the grouped matmuls from the port's picker
    (ops/gmm.py:pick_gmm_blocks), keyed on w_in's [e, d, f]; w_out
    shares it because both products share the one group padding."""
    e, d, f = w_in.shape
    return pick_gmm_blocks(d, f, e, w_in.dtype, rows=rows)["block_m"]


def _gmm_dispatch_combine(xf, gate_vals, expert_ids, w_in, w_out, e: int,
                          bm: int):
    """Sort -> grouped matmul -> unsort-combine: ``xf`` [n, d] tokens,
    per-token ``gate_vals``/``expert_ids`` [n, k] over ``e`` experts
    (``w_in`` [e, d, f], ``w_out`` [e, f, d]) -> [n, d].

    Tokens are sorted by routed expert, each expert's rows padded to a
    ``bm`` multiple inside the static row bound ``k*n + e*bm``, and the
    two expert products run as grouped matmuls (K5 forward; K5 for dx
    and K6 for dw in the backward).  Every shape is fixed by n, k, e
    and bm, and the group sizes stay on the device: no host sync.  As
    in the JAX package, int32 index scatters build the row maps and the
    activations move only through row gathers.  Under autograd a
    gather's backward accumulates into its source rows: each real row
    of ``y`` is gathered once, each token's k rows add their k
    gradients, and padding rows add exact zeros, so the sums do not
    depend on the order of accumulation for top_k <= 2.
    ``scatter_add_`` counts the rows per expert: ``torch.bincount``
    on the card reads its maximum back to the host."""
    n, d = xf.shape
    k = expert_ids.shape[1]
    dev = xf.device
    flat_e = expert_ids.reshape(-1)                          # [n*k]
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k)

    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    padded = _round_up(counts, bm)                           # group sizes
    offsets = torch.cumsum(padded, 0) - padded               # group starts
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    rank = (torch.arange(n * k, device=dev)
            - (torch.cumsum(counts, 0) - counts)[sorted_e])  # pos in group
    dest = offsets[sorted_e] + rank                          # [n*k] rows
    src_tok = flat_tok[order]

    m_pad = _round_up(n * k, bm) + e * bm                    # static bound
    # padding rows point at token 0 and are zero-masked; nothing reads
    # their outputs back
    tok_of_row = torch.zeros(m_pad, dtype=torch.long, device=dev)
    tok_of_row[dest] = src_tok
    row_live = torch.zeros((m_pad, 1), dtype=xf.dtype, device=dev)
    row_live[dest] = 1
    x_sorted = xf[tok_of_row] * row_live
    h = _gelu(gmm(x_sorted, w_in, padded, bm))
    y = gmm(h, w_out, padded, bm)                            # [m_pad, d]
    # unsort-combine: each token's k expert rows, weighted by its gates
    row_of_slot = torch.zeros(n * k, dtype=torch.long, device=dev)
    row_of_slot[order] = dest
    y_tok = y[row_of_slot].reshape(n, k, d)
    out = torch.einsum("nk,nkd->nd", gate_vals.to(y.dtype), y_tok)
    return out.to(xf.dtype)


def _moe_mlp_gmm(x, gates, layer, cfg: TransformerConfig):
    """Dropless sparse MoE through the grouped matmul, one device:
    top-k routing, then ``_gmm_dispatch_combine``."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gate_vals, expert_ids = torch.topk(gates.reshape(b * t, e), k, dim=-1)
    out = _gmm_dispatch_combine(x.reshape(b * t, d), gate_vals,
                                expert_ids, layer["w_in"], layer["w_out"],
                                e, _gmm_block_m(b * t * k, layer["w_in"]))
    return out.reshape(b, t, d)


def _dense_experts(x, g, layer):
    """The dense dispatch: every expert of ``layer`` (``w_in`` [E, d,
    f], ``w_out`` [E, f, d]) on every token of ``x`` [B, T, d], mixed by
    the gates ``g`` [B, T, E] in x's dtype."""
    h = _gelu(ein("btd,edf->btef", x, layer["w_in"]))
    y = ein("btef,efd->bted", h, layer["w_out"])
    return torch.einsum("bted,bte->btd", y, g)


def _moe_mlp_replicated(x, layer, cfg: TransformerConfig, mesh):
    """The dense-dispatch MoE MLP of a batch every rank of ``mesh``
    holds whole (decoding, models/decode.py: the batch is replicated
    over every axis).  This rank scores every token with the replicated
    router, takes its ``E/ep`` experts' slice of the gates, runs its
    ``d_ff/tp`` hidden units of them (w_in ``P("ep", None, "tp")``,
    w_out ``P("ep", "tp", None)``) and sums the partial output over tp
    and over ep.  :func:`_moe_mlp_sharded` would all-gather an ep shard
    of the batch and reduce-scatter the output back, handing each rank
    ``1/ep`` of a batch it already holds.  Forward only."""
    e = cfg.n_experts
    ep = mesh.size("ep")
    if e % ep:
        raise ValueError(
            f"moe_dispatch='dense' needs n_experts ({e}) divisible by "
            f"the ep axis ({ep})")
    gates, _, _ = _router_gates(x, layer, cfg)
    e_local = e // ep
    e0 = mesh.index("ep") * e_local
    out = _dense_experts(x, gates[..., e0:e0 + e_local].to(x.dtype), layer)
    return reduce_from(reduce_from(out, mesh, "tp"), mesh, "ep")


def _moe_mlp_sharded(x, gates, layer, cfg: TransformerConfig, mesh):
    """The MoE MLP over the process mesh, every dispatch: the JAX
    ``_moe_mlp_gmm_sharded`` skeleton (``transformer.py:541-612``),
    whose gmm core JAX runs under ``shard_map`` and whose dense and
    capacity dispatch it leaves to GSPMD.

    Per rank: this rank's expert block (``E/ep`` experts, ``d_ff/tp``
    hidden units: w_in ``P("ep", None, "tp")``, w_out ``P("ep", "tp",
    None)``), the ep part of the batch all-gathered (x and gates), every
    gathered token run against the local experts only, the partial
    output summed over tp and reduce-scattered back over ep, so exactly
    one rank owns each (token, expert) pair.  gmm routes each token's
    top-k picks, non-local ones to a zero-weight dead group ``e_local``
    with their gates zeroed, through ``_gmm_dispatch_combine`` over
    ``e_local + 1`` groups (K5/K6 per shard); its row block is JAX's,
    from the global ``(b/dp) (t/sp) k`` rows.  Dense and capacity take
    the local experts' slice of the gates; capacity counts each
    expert's budget over a row's whole sequence, so under sp it also
    gathers the sequence and keeps its own shard of the output."""
    e, k = cfg.n_experts, cfg.top_k
    ep = mesh.size("ep")
    if e % ep:
        raise ValueError(
            f"moe_dispatch={cfg.moe_dispatch!r} needs n_experts ({e}) "
            f"divisible by the ep axis ({ep})")
    e_local = e // ep
    e0 = mesh.index("ep") * e_local
    x = copy_to(x, mesh, "tp")
    gates = copy_to(gates, mesh, "tp")
    whole_rows = cfg.moe_dispatch == "capacity" and mesh.size("sp") > 1
    if whole_rows:
        x = all_gather_ad(x, mesh, "sp", 1)
        gates = all_gather_ad(gates, mesh, "sp", 1)
    xg = all_gather_ad(x, mesh, "ep", 0)
    gg = all_gather_ad(gates, mesh, "ep", 0)
    if cfg.moe_dispatch == "gmm":
        bg, tl, d = xg.shape
        n = bg * tl
        # JAX's per-shard routed rows: (b / dp) (t / sp) k over the
        # global b and t
        rows = (x.shape[0] * ep) * x.shape[1] * k
        w_in, w_out = layer["w_in"], layer["w_out"]
        bm = pick_gmm_blocks(cfg.d_model, cfg.d_ff, e, w_in.dtype,
                             rows=rows)["block_m"]
        gate_vals, expert_ids = torch.topk(gg.reshape(n, e), k, dim=-1)
        local = expert_ids - e0
        mine = (local >= 0) & (local < e_local)
        local_ids = torch.where(mine, local, e_local)         # dead group
        gate_loc = torch.where(mine, gate_vals, 0.0)
        out = _gmm_dispatch_combine(
            xg.reshape(n, d), gate_loc, local_ids,
            torch.cat([w_in, w_in.new_zeros((1,) + w_in.shape[1:])]),
            torch.cat([w_out, w_out.new_zeros((1,) + w_out.shape[1:])]),
            e_local + 1, bm).reshape(bg, tl, d)
    elif cfg.moe_dispatch == "capacity":
        out = _moe_mlp_capacity(xg, gg[..., e0:e0 + e_local], layer, cfg)
    else:
        out = _dense_experts(xg, gg[..., e0:e0 + e_local].to(xg.dtype),
                             layer)
    out = reduce_scatter_ad(reduce_from(out, mesh, "tp"), mesh, "ep", 0)
    if whole_rows:
        tl = out.shape[1] // mesh.size("sp")
        out = out[:, mesh.index("sp") * tl:(mesh.index("sp") + 1) * tl]
    return out


def _moe_mlp(x, layer, cfg: TransformerConfig, with_aux: bool = False,
             mesh=None):
    """The MoE MLP under ``cfg.moe_dispatch``: "dense" computes every
    expert on every token and mixes by the top-k-zeroed gates;
    "capacity" and "gmm" as above; over a mesh,
    :func:`_moe_mlp_sharded`.  ``with_aux`` also returns this layer's
    router objectives ``(load_balance, z)``.  gmm refuses int8
    ``QTensor`` experts and pipeline stages, as in the JAX package:
    quantized serving runs the dense dispatch, pipelined MoE configs
    capacity."""
    gates, probs, logits = _router_gates(x, layer, cfg)
    if cfg.moe_dispatch == "gmm":
        if isinstance(layer["w_in"], QTensor):
            raise NotImplementedError(
                "moe_dispatch='gmm' expects full-precision expert "
                "weights; quantized serving runs the dense dispatch "
                "(models/decode.py:_serving_cfg)")
        if mesh is not None and cfg.pp_stages > 1:
            raise NotImplementedError(
                "moe_dispatch='gmm' does not compose with pp stages; "
                "pipelined MoE configs use 'capacity'")
    if mesh is not None:
        out = _moe_mlp_sharded(x, gates, layer, cfg, mesh)
    elif cfg.moe_dispatch == "capacity":
        out = _moe_mlp_capacity(x, gates, layer, cfg)
    elif cfg.moe_dispatch == "gmm":
        out = _moe_mlp_gmm(x, gates, layer, cfg)
    else:
        out = _dense_experts(x, gates.to(x.dtype), layer)
    if with_aux:
        return out, _moe_aux(gates, probs, logits, cfg, mesh)
    return out


def _layer_forward(x, layer, cfg: TransformerConfig, segment_ids=None,
                   with_aux: bool = False, mesh=None):
    x = x + _attention(rms_norm(x, layer["ln1"]), layer, cfg, segment_ids,
                       mesh)
    mlp_in = rms_norm(x, layer["ln2"])
    if cfg.is_moe:
        if with_aux:
            out, aux = _moe_mlp(mlp_in, layer, cfg, with_aux=True,
                                mesh=mesh)
            return x + out, aux
        return x + _moe_mlp(mlp_in, layer, cfg, mesh=mesh)
    out = x + _dense_mlp(mlp_in, layer, mesh)
    if with_aux:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return out, (zero, zero)
    return out


def _pipelined_layers(x, params, cfg: TransformerConfig, mesh):
    """The layer stack as ``pp_stages`` pipelined stage groups
    (parallel/pipeline.py), this rank running its stage: the staged
    ``params["stages"]`` leaves (this stage's block, or all S stages),
    or a layers list staged on the fly.  Each stage applies its L/S
    layers with the mesh's other axes inside; ``cfg.remat`` maps to
    the pipeline's stage-level checkpoint."""
    from ..parallel.pipeline import pipeline_apply, split_layers
    lps = split_layers(cfg.n_layers, cfg.pp_stages)
    stacked = (params["stages"] if "stages" in params
               else stage_params(params, cfg)["stages"])

    def stage_fn(stage, x):
        for i in range(lps):
            x = _layer_forward(x, {n: a[i] for n, a in stage.items()},
                               cfg, mesh=mesh)
        return x

    return pipeline_apply(
        stage_fn, stacked, x, mesh=mesh,
        n_microbatches=cfg.pp_microbatches or 2 * cfg.pp_stages,
        checkpoint_stages=cfg.remat)


def _embed(params, tokens, cfg: TransformerConfig, mesh):
    """Embedding lookup; under tp this rank's d-slice (embed ``P(None,
    "tp")``), all-gathered along d."""
    x = take_rows(params["embed"], tokens, cfg.dtype)
    return gather_replicated(x, mesh, "tp", 2)


def _unembed(x, params, mesh):
    """Logits; under tp this rank's d-slice of x against its rows of the
    unembedding (``P("tp", None)``), the partial logits summed."""
    w = params["unembed"]
    if mesh is not None and mesh.size("tp") > 1:
        x = copy_to(x, mesh, "tp")
        n = w.shape[0]
        x = x[..., mesh.index("tp") * n:(mesh.index("tp") + 1) * n]
    return reduce_from(ein("btd,dv->btv", x, w), mesh, "tp")


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            segment_ids=None, return_aux: bool = False, mesh=None):
    """tokens [B, T] int -> logits [B, T, vocab].

    ``segment_ids`` [B, T] int32 packs several documents into one row:
    attention is masked within segments.  ``return_aux`` also returns
    ``{"load_balance": mean over layers, "router_z": ...}`` (zeros for
    dense-MLP configs), which ``loss_fn`` adds when the router aux
    weights are set.  Runs on the device the parameters live on.

    ``mesh`` (a ``parallel.mesh.ProcessMesh``): ``params`` are this
    rank's blocks (:func:`shard_params`); tokens and segment ids are
    this rank's ``[B/(dp ep), T/sp]`` shard (the shard at sp coordinate
    i holds positions ``[i T/sp, (i+1) T/sp)``), and the logits are that
    shard's, whole over the vocabulary: the JAX ``forward`` on the same
    mesh, cut to this rank's rows and positions.  A pp config pipelines
    its stages over the mesh's pp axis, with JAX's checks; without a
    mesh, staged params are unstaged and run in sequence."""
    pipelined = cfg.pp_stages > 1 and mesh is not None
    if pipelined:
        if mesh.size("pp") != cfg.pp_stages:
            raise ValueError(
                f"mesh pp axis {mesh.size('pp')} != pp_stages "
                f"{cfg.pp_stages}")
        if mesh.size("sp") > 1:
            raise ValueError(
                "pp_stages > 1 does not compose with sp sequence "
                "sharding (stages run their layers with the "
                "single-device path); use sp or pp, not both")
        if segment_ids is not None or return_aux:
            raise ValueError(
                "pp_stages > 1 supports neither segment_ids nor "
                "return_aux (stage traffic carries activations only)")
    elif "stages" in params:
        # staged params on the sequential path (a pp-trained checkpoint
        # evaluated unsharded)
        params = unstage_params(params, cfg)
    x = _embed(params, tokens, cfg, mesh)
    load_total = z_total = torch.zeros((), dtype=torch.float32,
                                       device=x.device)
    layers = [] if pipelined else params["layers"]
    if pipelined:
        x = _pipelined_layers(x, params, cfg, mesh)
    for layer in layers:
        if cfg.remat:
            # activations of the layer are recomputed in the backward,
            # as jax.checkpoint does for the JAX package's layer
            out = torch.utils.checkpoint.checkpoint(
                _layer_forward, x, layer, cfg, segment_ids, return_aux,
                mesh, use_reentrant=False)
        else:
            out = _layer_forward(x, layer, cfg, segment_ids, return_aux,
                                 mesh)
        if return_aux:
            x, (load, z) = out
            load_total = load_total + load
            z_total = z_total + z
        else:
            x = out
    x = rms_norm(x, params["ln_f"])
    logits = _unembed(x, params, mesh)
    if not return_aux:
        return logits
    n = max(len(params["layers"]), 1)
    return logits, {"load_balance": load_total / n, "router_z": z_total / n}


def loss_fn(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            segment_ids=None, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy, f32 scalar.

    The forward pass runs on the full sequence and the shift happens on
    the logits (taken in f32).  With ``segment_ids``, positions whose
    next token belongs to a different segment are excluded from the
    mean.  When an MoE config sets ``aux_loss_weight`` /
    ``router_z_weight``, the router objectives are added with those
    weights.

    With ``mesh`` (tokens and ids this rank's shard, as in
    :func:`forward`), see :func:`_mesh_loss`: the value is the JAX
    package's global loss on every rank."""
    want_aux = cfg.is_moe and (cfg.aux_loss_weight > 0
                               or cfg.router_z_weight > 0)
    if mesh is not None:
        return _mesh_loss(params, tokens, cfg, segment_ids, mesh, want_aux)
    if want_aux:
        logits, aux = forward(params, tokens, cfg, segment_ids,
                              return_aux=True)
    else:
        logits = forward(params, tokens, cfg, segment_ids)
    logp = torch.log_softmax(logits.float()[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    if segment_ids is None:
        loss = -ll.mean()
    else:
        keep = (segment_ids[:, 1:] == segment_ids[:, :-1]).to(ll.dtype)
        loss = -(ll * keep).sum() / torch.clamp(keep.sum(), min=1.0)
    if want_aux:
        loss = (loss + cfg.aux_loss_weight * aux["load_balance"]
                + cfg.router_z_weight * aux["router_z"])
    return loss


def _mesh_loss(params, tokens, cfg, segment_ids, mesh, want_aux=False):
    """The global next-token loss from this rank's shard.

    The shift crosses shard boundaries: a shard's last position
    predicts the next sp shard's first token (gathered along sp), and
    the globally last position is dropped; with segment ids the keep
    mask crosses the same way.  The mean is over every kept position of
    the global batch: the sum and the count all-reduced over the batch
    axes (dp, ep, sp; tp and pp ranks hold copies of their row's
    logits).  The router objectives, when weighted, are the global ones
    (:func:`_moe_aux`).

    The returned tensor's value is that global loss on every rank; its
    gradient is this rank's share (its own sum over the global count),
    so the sum of the gradients over the batch axes, which the train
    step takes, is the gradient of the global loss."""
    if want_aux:
        logits, aux = forward(params, tokens, cfg, segment_ids,
                              return_aux=True, mesh=mesh)
    else:
        logits = forward(params, tokens, cfg, segment_ids, mesh=mesh)
    sp, idx = mesh.size("sp"), mesh.index("sp")
    last = idx == sp - 1

    def shifted(x):
        """x's next position: x[:, 1:] and the next shard's first
        column (nothing after the globally last position)."""
        firsts = mesh.all_gather(x[:, :1], "sp", dim=1)
        return x[:, 1:] if last else torch.cat(
            [x[:, 1:], firsts[:, idx + 1:idx + 2]], dim=1)

    targets = shifted(tokens).long()
    n = targets.shape[1]
    logp = torch.log_softmax(logits.float()[:, :n], dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    if segment_ids is None:
        keep = torch.ones_like(ll)
    else:
        keep = (shifted(segment_ids) == segment_ids[:, :n]).to(ll.dtype)
    local = -(ll * keep).sum()
    totals = torch.stack([local.detach(), keep.sum()])
    for axis in _batch_axes(mesh):
        mesh.all_reduce_(totals, axis)
    count = torch.clamp(totals[1], min=1.0)
    share = local / count
    loss = share + (totals[0] / count - share).detach()
    if want_aux:
        loss = (loss + cfg.aux_loss_weight * aux["load_balance"]
                + cfg.router_z_weight * aux["router_z"])
    return loss


# --------------------------------------------------------------------------
# Training step
# --------------------------------------------------------------------------

def named_tensors(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Leaves of a parameter tree (dicts and lists) as ``(dotted path,
    tensor)`` pairs, dict keys sorted: the one order the optimizer and
    the checkpointer share."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in named_tensors(tree[key], f"{prefix}{key}.")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, node in enumerate(tree)
                for pair in named_tensors(node, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def bound_leaves(params, opt_state) -> list:
    """The leaves of ``params`` in ``named_tensors`` order, after checking
    that ``opt_state`` is the optimizer ``init_state`` bound to them
    (one parameter group holding exactly those tensors)."""
    leaves = [t for _, t in named_tensors(params)]
    bound = opt_state.param_groups[0]["params"]
    if (len(opt_state.param_groups) != 1 or len(bound) != len(leaves)
            or any(a is not b for a, b in zip(bound, leaves))):
        raise ValueError("opt_state is not bound to these params "
                         "(build both with init_state)")
    return leaves


def make_optimizer(lr: float = 3e-4) -> Callable[..., torch.optim.Optimizer]:
    """The counterpart of ``optax.adamw(lr, weight_decay=0.01)``: a
    factory that binds ``torch.optim.AdamW`` with optax's betas and eps
    to a list of parameters.  Decay is decoupled and applies to every
    leaf, as in optax; the moments are kept in the parameters' dtype,
    as optax keeps them."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def make_train_step(cfg: TransformerConfig, device="cuda",
                    optimizer: Callable[..., torch.optim.Optimizer]
                    | None = None, mesh=None):
    """Returns ``(train_step, init_state)``, the shape of the JAX
    ``make_train_step``.

    ``init_state(generator=None)`` -> ``(params, opt_state)``: params
    from :func:`init_params` on ``device`` with gradients on, and a
    fresh optimizer (``optimizer``, default :func:`make_optimizer`)
    bound to them.  ``train_step(params, opt_state, tokens,
    segment_ids=None)`` -> ``(params, opt_state, loss)``: loss and
    gradients of :func:`loss_fn`, then one optimizer step, in place;
    ``tokens`` [B, T] (tensor or numpy) is moved to ``device``.

    With ``mesh`` (a ``parallel.mesh.ProcessMesh`` on ``device``),
    ``init_state`` cuts this rank's blocks (:func:`shard_params`) from
    the whole initialization, which must be the same on every rank (the
    same generator seed), and the optimizer holds those blocks: a
    staged pp config keeps each stage's moments on its stage.  Every
    rank calls ``train_step`` with the same **global** ``[B, T]``
    batch, as the JAX step takes it, and works on its own ``B/(dp ep)
    x T/sp`` shard; after the backward each leaf's gradient is summed
    (in f32) over the batch axes its spec does not name, and embed's
    over pp (:func:`_sum_grads`), then every rank steps AdamW on its
    blocks.  The loss returned is the global one."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device != dev:
        raise ValueError(f"mesh computes on {mesh.device}, not {dev}")
    optimizer = optimizer or make_optimizer()

    def init_state(generator: torch.Generator | None = None):
        params = init_params(cfg, generator, device=dev)
        if mesh is not None:
            params = shard_params(params, cfg, mesh)
        leaves = [t.requires_grad_() for _, t in named_tensors(params)]
        return params, optimizer(leaves)

    def train_step(params, opt_state, tokens, segment_ids=None):
        leaves = bound_leaves(params, opt_state)
        tokens = torch.as_tensor(tokens)
        if segment_ids is not None:
            segment_ids = torch.as_tensor(segment_ids)
        if mesh is not None:
            tokens = mesh.local_batch(tokens)
            if segment_ids is not None:
                segment_ids = mesh.local_batch(segment_ids)
        tokens = tokens.to(dev)
        if segment_ids is not None:
            segment_ids = segment_ids.to(dev)
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, segment_ids, mesh)
        loss.backward()
        if mesh is not None and mesh.world_size > 1:
            _sum_grads(params, cfg, mesh)
        opt_state.step()
        return params, opt_state, loss.detach()

    return train_step, init_state


def _grad_axes(name: str, spec, mesh) -> tuple[str, ...]:
    """The mesh axes a leaf's gradient is summed over after the
    backward: each batch axis (dp, ep, sp) its spec does not name, and
    pp for ``embed``, which stage 0 alone feeds.  Never tp: ``copy_to``
    makes a tp-replicated leaf's gradient whole on every tp rank; nor
    ep for an ep-sharded expert block, whose all-gather's backward
    already brought every token's part."""
    named = {a for entry in tuple(spec) for a in spec_axes(entry)}
    axes = tuple(a for a in _batch_axes(mesh) if a not in named)
    if name == "embed" and mesh.size("pp") > 1:
        axes += ("pp",)
    return axes


def _sum_grads(params, cfg: TransformerConfig, mesh) -> None:
    """Sum each leaf's gradient over its :func:`_grad_axes` (in f32, one
    all-reduce an axis for every set of leaves that shares them) and
    write the sums back in the gradients' dtype.  ``params`` are in the
    layout of :func:`param_specs` (staged for a pp config)."""
    specs = dict(tree_flatten_with_path(param_specs(cfg)))
    groups: dict = {}
    for path, t in tree_flatten_with_path(params):
        name, spec = leaf_name(path), specs[path]
        if t.grad is None:
            raise RuntimeError(f"parameter {name} got no gradient on this "
                               f"rank")
        axes = _grad_axes(name, spec, mesh)
        if axes:
            groups.setdefault(axes, []).append(t.grad)
    for axes, grads in groups.items():
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        for axis in axes:
            mesh.all_reduce_(flat, axis)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


__all__ = ["Params", "TransformerConfig", "forward", "gather_params",
           "grad_tree", "init_params", "loss_fn", "make_optimizer",
           "make_train_step", "named_tensors", "param_specs", "rms_norm",
           "rotary", "shard_params", "stage_params", "unstage_params"]
