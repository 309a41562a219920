"""Decoder-only transformer: config, parameters, the forward pass and
the training step.

The port of ``k8s_dra_driver_tpu/models/transformer.py`` for dense
configs on one device.  Parameters keep the JAX package's layout and
key names — ``wq [d,h,dh]``, ``wk/wv [d,h_kv,dh]``, ``wo [h,dh,d]``,
``w_in [d,f]``, ``w_out [f,d]``, ``embed [V,d]``, ``unembed [d,V]``,
``ln1/ln2/ln_f [d]`` in a dict with a ``layers`` list — so the same
einsum specs apply and ``models/convert.py`` moves a JAX checkpoint
over key for key.

Numerics follow the reference where PyTorch's defaults differ: GELU is
the tanh approximation (``jax.nn.gelu``'s default), RoPE rotates
interleaved pairs, RMSNorm takes its variance in f32 and multiplies in
x's dtype.

Training: ``loss_fn`` (next-token NLL, f32 logits, segment keep-mask),
``make_optimizer`` (AdamW, optax's defaults) and ``make_train_step``.
The step updates the parameters and the optimizer state in place
(where JAX donates its buffers); gradients reach every weight, the
attention projections through the flash backward kernels K3/K4 on the
card.

Not ported yet: MoE (``n_experts > 0``) and the mesh / pipeline
paths.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import attention_reference
from ..utils.device import resolve_device
from .quant import ein, take_rows

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields, defaults and validation as the JAX
    ``TransformerConfig``; ``dtype`` is a torch dtype.  Fields of
    paths the port does not run yet (MoE dispatch, pipeline, int8 KV)
    are validated here and refused where they would be used."""

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


def require_dense(cfg: TransformerConfig) -> None:
    """Refuse configs whose layers the port cannot run yet."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE layers (n_experts > 0) come with the sparse-MoE slice "
            "of the port (grouped-matmul kernels)")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    return {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, h, dh), "wk": (d, cfg.kv_heads, dh),
        "wv": (d, cfg.kv_heads, dh),
        "wo": (h, dh, d),
        "w_in": (d, f), "w_out": (f, d),
    }


def init_params(cfg: TransformerConfig,
                generator: torch.Generator | None = None,
                device="cuda") -> Params:
    """Random parameters in the JAX layout: normal(0, fan_in^-1/2)
    matrices, ones for the norms.  Values are drawn in f32 on
    ``generator``'s device (default: a CPU generator seeded 0) and
    cast to ``cfg.dtype`` on ``device``; they do not match JAX's.

    ``fan_in`` is each matrix's contraction size (``d_model`` for
    wq/wk/wv/w_in, ``h * d_head`` for wo, ``d_ff`` for w_out).  The JAX
    package takes the second-to-last dim instead, which for the 3-D
    attention weights is a head count: its q and k come out with
    standard deviations near 8 and 16 at the 154M shape, attention is
    nearly one-hot, and two bf16 evaluations of one prefix can then
    differ by whole logits.  With the contraction size, bf16 decode and
    the full forward agree closely enough to check one against the
    other."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": h * dh, "w_in": d,
              "w_out": cfg.d_ff}

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


def _attention(x, layer, cfg: TransformerConfig, segment_ids=None):
    """Single-device attention: flash attention on the card (K1
    forward, K3/K4 backward), the dense oracle elsewhere — the split
    ``transformer.py:365-374`` makes between the TPU and other
    backends."""
    b, t, d = x.shape
    positions = torch.arange(t, device=x.device)
    q = rotary(ein("btd,dhk->bthk", x, layer["wq"]), positions,
               cfg.rope_theta)
    k = rotary(ein("btd,dhk->bthk", x, layer["wk"]), positions,
               cfg.rope_theta)
    v = ein("btd,dhk->bthk", x, layer["wv"])
    window = cfg.attention_window or None
    if x.device.type == "cuda":
        seg = (segment_ids.to(torch.int32).contiguous()
               if segment_ids is not None else None)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=window, segment_ids=seg)
    else:
        o = attention_reference(q, k, v, causal=True, window=window,
                                segment_ids=segment_ids).to(x.dtype)
    return ein("bthk,hkd->btd", o, layer["wo"])


def _dense_mlp(x, layer):
    h = F.gelu(ein("btd,df->btf", x, layer["w_in"]), approximate="tanh")
    return ein("btf,fd->btd", h, layer["w_out"])


def _layer_forward(x, layer, cfg: TransformerConfig, segment_ids=None):
    x = x + _attention(rms_norm(x, layer["ln1"]), layer, cfg, segment_ids)
    return x + _dense_mlp(rms_norm(x, layer["ln2"]), layer)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            segment_ids=None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab].

    ``segment_ids`` [B, T] int32 packs several documents into one row:
    attention is masked within segments.  Runs on the device the
    parameters live on."""
    require_dense(cfg)
    x = take_rows(params["embed"], tokens, cfg.dtype)
    for layer in params["layers"]:
        if cfg.remat:
            # activations of the layer are recomputed in the backward,
            # as jax.checkpoint does for the JAX package's layer
            x = torch.utils.checkpoint.checkpoint(
                _layer_forward, x, layer, cfg, segment_ids,
                use_reentrant=False)
        else:
            x = _layer_forward(x, layer, cfg, segment_ids)
    x = rms_norm(x, params["ln_f"])
    return ein("btd,dv->btv", x, params["unembed"])


def loss_fn(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            segment_ids=None) -> torch.Tensor:
    """Next-token cross-entropy, f32 scalar.

    The forward pass runs on the full sequence and the shift happens on
    the logits (taken in f32).  With ``segment_ids``, positions whose
    next token belongs to a different segment are excluded from the
    mean."""
    logits = forward(params, tokens, cfg, segment_ids).float()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    if segment_ids is None:
        return -ll.mean()
    keep = (segment_ids[:, 1:] == segment_ids[:, :-1]).to(ll.dtype)
    return -(ll * keep).sum() / torch.clamp(keep.sum(), min=1.0)


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
                    | None = None):
    """Returns ``(train_step, init_state)`` for one device, the shape
    of the JAX ``make_train_step`` without the mesh.

    ``init_state(generator=None)`` -> ``(params, opt_state)``: params
    from :func:`init_params` on ``device`` with gradients on, and a
    fresh optimizer (``optimizer``, default :func:`make_optimizer`)
    bound to them.  ``train_step(params, opt_state, tokens,
    segment_ids=None)`` -> ``(params, opt_state, loss)``: loss and
    gradients of :func:`loss_fn`, then one optimizer step, in place;
    ``tokens`` [B, T] (tensor or numpy) is moved to ``device``."""
    require_dense(cfg)
    dev = resolve_device(device)
    optimizer = optimizer or make_optimizer()

    def init_state(generator: torch.Generator | None = None):
        params = init_params(cfg, generator, device=dev)
        leaves = [t.requires_grad_() for _, t in named_tensors(params)]
        return params, optimizer(leaves)

    def train_step(params, opt_state, tokens, segment_ids=None):
        leaves = [t for _, t in named_tensors(params)]
        bound = opt_state.param_groups[0]["params"]
        if (len(opt_state.param_groups) != 1 or len(bound) != len(leaves)
                or any(a is not b for a, b in zip(bound, leaves))):
            raise ValueError("opt_state is not bound to these params "
                             "(build both with init_state)")
        tokens = torch.as_tensor(tokens, device=dev)
        if segment_ids is not None:
            segment_ids = torch.as_tensor(segment_ids, device=dev)
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, segment_ids)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return train_step, init_state


__all__ = ["Params", "TransformerConfig", "forward", "init_params",
           "loss_fn", "make_optimizer", "make_train_step",
           "named_tensors", "rms_norm", "rotary"]
