"""Weight-only int8 quantization for the serving path.

The port of ``k8s_dra_driver_tpu/models/quant.py``.  Weights are
quantized to int8 with **per-output-channel symmetric scales**, shaped
so the matmul consumes the int8 tensor and the scale multiplies the
output:

- quantize:  ``scale = max|w| / 127`` over the *contraction* dims,
  ``q = round(w / scale)`` (round half to even, clipped to +-127),
  computed in f32 exactly as the JAX package does, so ``q`` and
  ``scale`` are bit for bit the same;
- matmul:    decode-shaped calls (at most ``_KERNEL_MAX_M`` = 64 rows)
  go through the hand-written Hopper kernel K7
  (``csrc/int8_matmul_sm90.cu`` via :func:`int8_matmul` /
  :func:`int8_bmm`), which reads the int8 weight from device memory,
  converts it on chip, sums in f32 (bf16 x on the tensor cores, f32 x
  on the CUDA cores, :func:`int8_route`; K split across blocks by the
  plan :func:`pick_int8_tiles` takes from the autotune table, else
  :func:`int8_plan`'s) and applies the per-channel scale and the cast
  to x's dtype in its epilogue;
- larger calls take ``einsum(spec, x, q.to(x.dtype))`` and rescale
  the output in f32, as the JAX package's default path does.

Where the port parts from the JAX package: there the kernel is opt-in
(``TPU_QUANT_KERNEL=1``), for reasons of the TPU (readings that swung
between captures, and XLA fusing the int8 convert into the dot).  In
eager PyTorch the einsum path writes a full bf16 copy of the weight to
device memory and reads it back, three times the int8 bytes, so the
port routes every call with M <= 64 to K7 with no flag.  The function
is the same; the kernel rounds once (after the scale) where the einsum
path rounds the product to x's dtype and again after the scale.

Embeddings quantize per *row* (the gather axis) and are rescaled after
the gather.  ``launches`` counts K7's launches by entry point and
``tc_launches`` those on the tensor-core route; CPU calls take the
plain versions and never count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..ops import _build, autotune
from ..utils.device import on_card

#: kernel launches on CUDA tensors, by entry point: K7a
#: (``"int8_matmul"``) and K7b (``"int8_bmm"``)
launches = {"int8_matmul": 0, "int8_bmm": 0}
#: of K7's launches (both entry points), those on the tensor-core route
tc_launches = 0

#: decode-shaped calls (few rows) go to K7; larger M takes the einsum
_KERNEL_MAX_M = 64


@dataclasses.dataclass
class QTensor:
    """int8 values + broadcast-ready f32 scale (same rank as ``q``,
    contraction dims reduced to 1)."""

    q: torch.Tensor                 # int8, original weight shape
    scale: torch.Tensor             # float32, 1 on contracted dims

    @property
    def shape(self):
        return self.q.shape

    @property
    def size(self) -> int:
        return self.q.numel()

    @property
    def device(self) -> torch.device:
        return self.q.device

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def quantize(w: torch.Tensor, contract_dims: tuple[int, ...]) -> QTensor:
    """Symmetric per-channel int8: one scale per slice along every
    non-contracted dim; ``contract_dims`` are the axes a downstream
    matmul reduces over (they share one scale so the rescale can move
    past the reduction)."""
    w = w.float()
    amax = w.abs().amax(dim=contract_dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def _spec_parts(spec: str) -> tuple[str, str, str]:
    ins, out = spec.split("->")
    x_labels, w_labels = ins.split(",")
    return x_labels, w_labels, out


def _contracted(spec: str) -> tuple[int, ...]:
    """The dims of ``einsum(spec, x, w)``'s second operand that the
    product reduces over: the w labels missing from the output."""
    _, w_labels, out = _spec_parts(spec)
    contract = tuple(i for i, lbl in enumerate(w_labels)
                     if lbl not in out)
    if not contract:
        raise ValueError(f"no contraction dims in {spec!r}")
    return contract


def quantize_for(spec: str, w: torch.Tensor) -> QTensor:
    """Quantize ``w`` for use as the second operand of
    ``einsum(spec, x, w)``: contraction dims are the w labels missing
    from the output."""
    return quantize(w, _contracted(spec))


# --------------------------------------------------------------------------
# K7: out[g] = (x[g] @ q[g]) * scale[g], f32 sums, cast to x's dtype
# --------------------------------------------------------------------------

def int8_matmul_reference(x, q, scale):
    """Plain PyTorch version of K7a: ``[M, K] @ [K, N]`` int8 in f32,
    times ``scale`` ([N]-broadcastable f32), cast to x's dtype."""
    n = q.shape[1]
    out = (x.float() @ q.float()) * scale.reshape(1, n).float()
    return out.to(x.dtype)


def int8_bmm_reference(x, q, scale):
    """Plain PyTorch version of K7b: ``[G, M, K] @ [G, K, N]`` int8 in
    f32, times ``scale`` ([G, 1, N]-broadcastable f32), cast to x's
    dtype."""
    g, _, n = q.shape
    out = torch.bmm(x.float(), q.float()) * scale.reshape(g, 1, n).float()
    return out.to(x.dtype)


#: K7 route by x's dtype
_ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
#: the K7 block: k rows a step (4 warps x k16), output columns, and
#: rows by route
INT8_K_STEP = 64
INT8_TILE_N = 128
INT8_TILE_M = {"tensor_cores": 16, "cuda_cores": 4}
#: the H100's SMs; a plan aims at two waves of blocks
_SMS = 132
_TARGET_BLOCKS = 2 * _SMS
#: the grid's limit on G * splits
_MAX_Z = 65535
#: the deep register ring (three k16 steps a warp in flight, bf16
#: only) costs registers down to three blocks an SM: grids of at most
#: this many blocks take it, when each warp walks at least
#: _DEEP_RING_STEPS steps (a shorter walk has nothing to keep in flight)
_DEEP_RING_BLOCKS = 3 * _SMS
_DEEP_RING_STEPS = 3


def int8_route(dtype) -> str:
    """The route K7 takes on the card for x of ``dtype``:
    ``"tensor_cores"`` for bfloat16 (W8A16: the weight converted to
    bf16 in registers, exact), ``"cuda_cores"`` for float32 (f32 FMA,
    not TF32, which would round x).  Raises for any other dtype: there
    is no fallback."""
    route = _ROUTES.get(dtype)
    if route is None:
        raise ValueError(f"the int8 kernel takes float32 or bfloat16 x, "
                         f"got {dtype}")
    return route


class Int8Plan(NamedTuple):
    """K7's grid for one call: rows and columns of a block's tile, K cut
    into ``splits`` chunks of ``k_chunk`` rows, the blocks, and the k16
    steps a warp keeps in its register ring (2 or 3)."""

    m_tile: int
    n_tile: int
    splits: int
    k_chunk: int
    blocks: int
    ring: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def int8_plan(g: int, m: int, k: int, n: int,
              dtype=torch.bfloat16) -> Int8Plan:
    """How K7 cuts ``[G, M, K] x [G, K, N]`` for x of ``dtype``.  The
    output tiles (G x M / m_tile x N / 128) that fill the card alone
    (at least one block an SM, the 154M unembedding) keep K whole
    (``splits`` = 1).  Fewer tiles split K into chunks of whole k steps
    until there are two waves of blocks (:data:`_TARGET_BLOCKS`), or
    every chunk is one k step where K is too short for that.  The
    chunks cover K exactly once: the last may be ragged.  A bf16 grid
    that fits at three blocks an SM, whose warps walk at least three
    k16 steps each, takes the deeper register ring."""
    route = int8_route(dtype)
    m_tile = INT8_TILE_M[route]
    tiles = g * _cdiv(m, m_tile) * _cdiv(n, INT8_TILE_N)
    steps = _cdiv(k, INT8_K_STEP)
    per = steps
    if tiles < _SMS:
        per = max(1, steps // _cdiv(_TARGET_BLOCKS, tiles))
    per = max(per, _cdiv(steps, max(1, _MAX_Z // g)))
    splits = _cdiv(steps, per)
    blocks = tiles * splits
    # each of the block's 4 warps walks one k16 step of every k step
    deep = (route == "tensor_cores" and blocks <= _DEEP_RING_BLOCKS
            and per >= _DEEP_RING_STEPS)
    return Int8Plan(m_tile, INT8_TILE_N, splits, per * INT8_K_STEP, blocks,
                    3 if deep else 2)


#: K7's register rings by route: the deep ring of three k16 steps a warp
#: holds x in registers too and exists on the tensor-core route only
_RINGS = {"tensor_cores": (2, 3), "cuda_cores": (2,)}


def _tuned_plan(params: dict, g: int, m: int, k: int, n: int, dtype,
                key: str) -> Int8Plan:
    """The plan of a table entry ``{"k_chunk", "ring"}`` for this shape;
    raises ``ValueError`` naming ``key`` for an entry the kernel cannot
    take (``csrc/int8_matmul_sm90.cu`` refuses the same plans)."""
    route = int8_route(dtype)
    try:
        k_chunk, ring = int(params["k_chunk"]), int(params["ring"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"autotune entry {key}: want integer k_chunk and "
                         f"ring, got {params}") from e
    if k_chunk <= 0 or k_chunk % INT8_K_STEP:
        raise ValueError(f"autotune entry {key}: k_chunk {k_chunk} is not "
                         f"a positive multiple of {INT8_K_STEP}")
    if ring not in _RINGS[route]:
        raise ValueError(f"autotune entry {key}: ring {ring} is not one "
                         f"of {_RINGS[route]} on the {route} route")
    splits = _cdiv(k, k_chunk)
    if g * splits > _MAX_Z:
        raise ValueError(f"autotune entry {key}: G x splits = "
                         f"{g * splits} exceeds the grid's {_MAX_Z}")
    m_tile = INT8_TILE_M[route]
    blocks = g * _cdiv(m, m_tile) * _cdiv(n, INT8_TILE_N) * splits
    return Int8Plan(m_tile, INT8_TILE_N, splits, k_chunk, blocks, ring)


def pick_int8_tiles(g: int, m: int, k: int, n: int, dtype=torch.bfloat16,
                    batched: bool = False) -> Int8Plan:
    """K7's plan for ``[G, M, K] x [G, K, N]`` from the autotune table
    (``ops/autotune.py``; kernel ``"int8_bmm"`` when ``batched``, else
    ``"int8_matmul"``; shape key ``g,k,m,n``), falling back to
    :func:`int8_plan`.  A table entry tunes ``k_chunk`` (a whole number
    of :data:`INT8_K_STEP`, which fixes ``splits``) and ``ring``; tile M
    and N stay the route's.  Host-only and cached per shape and dtype
    on the table, so it runs inside CUDA-graph capture.  The port's
    counterpart of the JAX package's ``pick_int8_tiles``, whose
    parameters are the Pallas tiles instead."""
    tuner = autotune.get_autotuner()

    def build() -> Int8Plan:
        kernel = "int8_bmm" if batched else "int8_matmul"
        key = autotune.shape_key(g=g, m=m, k=k, n=n)
        choice = tuner.pick(kernel, key, dtype, default={})
        if choice.source == "default":
            return int8_plan(g, m, k, n, dtype)
        return _tuned_plan(choice.params, g, m, k, n, dtype,
                           autotune.table_key(kernel, key, dtype,
                                              autotune.backend_key()))

    return tuner.memo(("int8", batched, g, m, k, n, dtype), build)


def _check(x, q, scale, batched: bool) -> None:
    want = 3 if batched else 2
    if x.ndim != want or q.ndim != want:
        raise ValueError(f"x and q must be {want}-d, got {tuple(x.shape)} "
                         f"/ {tuple(q.shape)}")
    if x.shape[-1] != q.shape[-2] or (batched and x.shape[0] != q.shape[0]):
        raise ValueError(f"x {tuple(x.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(f"q must be int8, got {q.dtype}")
    n_scales = q.shape[0] * q.shape[-1] if batched else q.shape[-1]
    if scale.numel() != n_scales:
        raise ValueError(f"scale of {scale.numel()} entries does not "
                         f"match q {tuple(q.shape)}")


def _launch(x3, q3, scale2, out3, name: str, k_chunk=None,
            ring=None) -> None:
    """K7 on ``x3`` [G, M, K] (any strides, unit stride along K: the
    shared x of the MoE up-projection has stride 0 along G), ``q3``
    [G, K, N] int8 and ``scale2`` [G, N] f32, both contiguous, into
    ``out3`` [G, M, N] (any strides, unit stride along N), by the route
    of x's dtype and the plan :func:`pick_int8_tiles` gives
    (:func:`int8_plan`'s unless the autotune table has the shape).  An
    explicit ``k_chunk`` or ``ring`` wins over the pick (the tuner
    measures specific plans); the pick fills in the other."""
    global tc_launches
    route = int8_route(x3.dtype)
    code = _build.DTYPE_CODES[str(x3.dtype).removeprefix("torch.")]
    if scale2.dtype != torch.float32:
        raise ValueError(f"{name}: scale must be float32, got "
                         f"{scale2.dtype}")
    for what, t in (("q", q3), ("scale", scale2), ("out", out3)):
        if t.device != x3.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on "
                             f"{x3.device}")
    if not (q3.is_contiguous() and scale2.is_contiguous()):
        raise ValueError(f"{name}: q and scale must be contiguous")
    if x3.stride(2) != 1 or out3.stride(2) != 1:
        raise ValueError(f"{name}: x and out need unit stride along "
                         f"their last dim")
    g, m, k_dim = x3.shape
    n_dim = q3.shape[2]
    plan = pick_int8_tiles(g, m, k_dim, n_dim, x3.dtype,
                           batched=name == "int8_bmm")
    if k_chunk is not None or ring is not None:
        plan = _tuned_plan(
            {"k_chunk": plan.k_chunk if k_chunk is None else k_chunk,
             "ring": plan.ring if ring is None else ring},
            g, m, k_dim, n_dim, x3.dtype, f"{name} explicit plan")
    # the f32 partial tiles of a split K, added in slice order by the
    # kernel's second pass
    ws = (torch.empty((plan.splits, g, m, n_dim), dtype=torch.float32,
                      device=x3.device) if plan.splits > 1 else None)
    lib = _build.library()
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = lib.int8_matmul(x3.data_ptr(), q3.data_ptr(),
                             scale2.data_ptr(), out3.data_ptr(),
                             None if ws is None else ws.data_ptr(), g, m,
                             k_dim, n_dim, x3.stride(0), x3.stride(1),
                             out3.stride(0), out3.stride(1), plan.splits,
                             plan.k_chunk, plan.ring, code, stream)
    _build.check(rc, name)
    launches[name] += 1
    tc_launches += route == "tensor_cores"


def int8_matmul(x, q, scale, k_chunk=None, ring=None):
    """``[M, K] @ [K, N]`` int8 -> ``[M, N]`` in x's dtype, rescaled by
    ``scale`` ([N]-broadcastable f32): K7a on CUDA tensors (x float32
    or bfloat16 with unit stride along K; q contiguous), the plain
    version on CPU tensors.  ``k_chunk``/``ring`` default to
    :func:`pick_int8_tiles`; explicit values win (the autotuner measures
    specific plans)."""
    _check(x, q, scale, batched=False)
    if not on_card(x, "int8_matmul"):
        return int8_matmul_reference(x, q, scale)
    m, n = x.shape[0], q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _launch(x[None], q[None], scale.reshape(1, n), out[None],
            "int8_matmul", k_chunk, ring)
    return out


def int8_bmm(x, q, scale, out=None, k_chunk=None, ring=None):
    """Batched ``[G, M, K] @ [G, K, N]`` int8 -> ``[G, M, N]`` in x's
    dtype, rescaled by ``scale`` ([G, 1, N]-broadcastable f32): K7b on
    CUDA tensors, the plain version on CPU tensors.  ``x`` may be any
    view with unit stride along K (an expanded x shared by every
    expert has stride 0 along G); ``out``, when given, is a [G, M, N]
    view with unit stride along N (a permuted [M, G, N] buffer, say)
    that receives the result and is returned.  ``k_chunk``/``ring`` as
    in :func:`int8_matmul`."""
    _check(x, q, scale, batched=True)
    g, m, _ = x.shape
    n = q.shape[2]
    if out is not None and tuple(out.shape) != (g, m, n):
        raise ValueError(f"out must be {(g, m, n)}, got {tuple(out.shape)}")
    if not on_card(x, "int8_bmm"):
        res = int8_bmm_reference(x, q, scale)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((g, m, n), dtype=x.dtype, device=x.device)
    _launch(x, q, scale.reshape(g, n), out, "int8_bmm", k_chunk, ring)
    return out


# --------------------------------------------------------------------------
# qeinsum: the routing of the JAX package's ``_qeinsum_impl``
# --------------------------------------------------------------------------

def _as_2d_matmul(spec: str, x: torch.Tensor, w: QTensor):
    """Detect specs that collapse to one [M,K]x[K,N] matmul: w labels =
    [contracted...][kept...] in order, x labels = [batch...][same
    contracted...], out = [batch...][kept...].  Returns (x2d, q2d,
    scale [N], out_shape) or None."""
    x_labels, w_labels, out = _spec_parts(spec)
    contract = [lbl for lbl in w_labels if lbl not in out]
    kept = [lbl for lbl in w_labels if lbl in out]
    nc = len(contract)
    if (list(w_labels) != contract + kept
            or list(x_labels[-nc:]) != contract
            or any(lbl in w_labels for lbl in x_labels[:-nc])
            or list(out) != list(x_labels[:-nc]) + kept):
        return None
    batch_shape = tuple(x.shape[:-nc])
    k_dim = 1
    for d in x.shape[-nc:]:
        k_dim *= d
    n_dim = w.size // k_dim
    x2d = x.reshape(-1, k_dim)
    q2d = w.q.reshape(k_dim, n_dim)
    scale_n = w.scale.reshape(n_dim)
    return x2d, q2d, scale_n, batch_shape + tuple(w.shape[nc:])


def _use_kernel(m: int) -> bool:
    """Decode-shaped calls (``m <= _KERNEL_MAX_M`` rows) take K7; the
    JAX package's ``TPU_QUANT_KERNEL`` opt-in has no counterpart here
    (see the module docstring)."""
    return m <= _KERNEL_MAX_M


def _qeinsum_impl(spec: str, x: torch.Tensor, w: QTensor) -> torch.Tensor:
    _, w_labels, out = _spec_parts(spec)
    if x.stride(-1) != 1:
        x = x.contiguous()        # K7 reads x with unit stride along K
    two_d = _as_2d_matmul(spec, x, w)
    if two_d is not None:
        x2d, q2d, scale_n, out_shape = two_d
        if _use_kernel(x2d.shape[0]):
            return int8_matmul(x2d, q2d, scale_n).reshape(out_shape)
    elif spec == "btd,edf->btef":
        # MoE up-projection: one batched call, x shared by every expert
        # through a stride-0 view, the output written straight into
        # [b*t, e, f] through a permuted view: no copy either way
        b, t, d = x.shape
        e, f = w.shape[0], w.shape[2]
        if _use_kernel(b * t):
            x3 = x.reshape(1, b * t, d).expand(e, b * t, d)
            y = torch.empty((b * t, e, f), dtype=x.dtype, device=x.device)
            int8_bmm(x3, w.q, w.scale, out=y.permute(1, 0, 2))
            return y.reshape(b, t, e, f)
    elif spec == "btef,efd->bted":
        # MoE down-projection: the expert is a shared batch dim, read
        # in place through a permuted view of x
        b, t, e, f = x.shape
        d = w.shape[2]
        if _use_kernel(b * t):
            x3 = x.reshape(b * t, e, f).permute(1, 0, 2)
            y = torch.empty((b * t, e, d), dtype=x.dtype, device=x.device)
            int8_bmm(x3, w.q, w.scale, out=y.permute(1, 0, 2))
            return y.reshape(b, t, e, d)
    y = torch.einsum(spec, x, w.q.to(x.dtype))
    # broadcast the kept scales into output axes; contracted scale dims
    # are already 1, kept dims map by label
    shape = tuple(w.scale.shape[w_labels.index(lbl)] if lbl in w_labels
                  else 1 for lbl in out)
    return (y.float() * w.scale.reshape(shape)).to(x.dtype)


class _QEinsum(torch.autograd.Function):
    """The JAX package's custom VJP: differentiable in x only.  dx is
    ``einsum(out, W -> x)`` on the dequantized weight in f32, cast to
    the cotangent's dtype; the int8 weights are frozen and get no
    gradient.  The JAX package has no backward kernel here, so neither
    has the port."""

    @staticmethod
    def forward(ctx, spec, x, q, scale):
        w = QTensor(q=q, scale=scale)
        ctx.spec = spec
        ctx.save_for_backward(q, scale)
        return _qeinsum_impl(spec, x, w)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        x_labels, w_labels, out = _spec_parts(ctx.spec)
        dx = torch.einsum(f"{out},{w_labels}->{x_labels}", g.float(),
                          QTensor(q=q, scale=scale).dequant())
        return None, dx.to(g.dtype), None, None


def qeinsum(spec: str, x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """``einsum(spec, x, dequant(w))`` with the dequantization split so
    the product reads int8: K7 for decode-shaped calls, otherwise the
    einsum on the int8 -> x.dtype convert and a per-channel rescale of
    the output.  Differentiable in ``x`` only."""
    return _QEinsum.apply(spec, x, w.q, w.scale)


def ein(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum that dispatches on the weight type: QTensor -> qeinsum,
    plain tensor -> ``torch.einsum`` (the large projections stay plain
    matmuls, as the JAX package left them to XLA).  The forward paths
    call this, so one code path serves both full-precision and
    quantized parameters."""
    if isinstance(w, QTensor):
        return qeinsum(spec, x, w)
    return torch.einsum(spec, x, w)


def take_rows(table, tokens: torch.Tensor, dtype=None):
    """Embedding lookup that dispatches on the table type.  Quantized
    tables are gathered as int8 and rescaled per row after the gather
    (scale shape [vocab, 1] -> gathered [..., 1])."""
    if isinstance(table, QTensor):
        out = table.q[tokens].float() * table.scale[tokens]
    else:
        out = table[tokens]
    return out.to(dtype) if dtype is not None else out


# Einsum specs each weight participates in (transformer.py / decode.py);
# embeddings are handled separately (gather, per row).
_WEIGHT_SPECS = {
    "wq": "btd,dhk->bthk", "wk": "btd,dhk->bthk", "wv": "btd,dhk->bthk",
    "wo": "bthk,hkd->btd",
    "w_in": None,       # dense "btd,df->btf" / moe "btd,edf->btef"
    "w_out": None,      # dense "btf,fd->btd" / moe "btef,efd->bted"
    "unembed": "btd,dv->btv",
}


def _leaf_spec(name: str, moe: bool) -> str:
    """The einsum spec weight leaf ``name`` is the second operand of."""
    if name == "w_in":
        return "btd,edf->btef" if moe else "btd,df->btf"
    if name == "w_out":
        return "btef,efd->bted" if moe else "btf,fd->btd"
    return _WEIGHT_SPECS[name]


def scale_dims(name: str, moe: bool) -> tuple[int, ...]:
    """The dims along which :func:`quantize_params` reduced weight leaf
    ``name``'s scale to size 1: its contraction dims, the embedding's
    d (it is quantized per row).  A mesh cuts a ``QTensor``'s scale by
    the leaf's spec on every other dim (models/transformer.py
    ``shard_params``)."""
    return (1,) if name == "embed" else _contracted(_leaf_spec(name, moe))


def quantize_params(params: dict[str, Any], cfg) -> dict[str, Any]:
    """Full-model weight-only quantization.  Layer norms and the MoE
    router stay full precision (tiny, accuracy-sensitive); everything
    that streams per token is int8.

    Works on the tree from ``init_params`` (transformer.py); the result
    drops into ``forward``, the cache paths and ``ServingEngine``
    unchanged, since their einsums go through :func:`ein`.  pp staged
    params are unstaged first (serving is single-device)."""
    if "stages" in params:
        from .transformer import unstage_params
        params = unstage_params(params, cfg)
    moe = cfg.is_moe
    out: dict[str, Any] = {
        "embed": quantize(params["embed"], (1,)),   # per row, for gather
        "unembed": quantize_for("btd,dv->btv", params["unembed"]),
        "ln_f": params["ln_f"],
        "layers": [],
    }
    for layer in params["layers"]:
        qlayer: dict[str, Any] = {}
        for name, w in layer.items():
            if name.startswith("ln") or name == "router":
                qlayer[name] = w
            else:
                qlayer[name] = quantize_for(_leaf_spec(name, moe), w)
        out["layers"].append(qlayer)
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def quantized_bytes(params: dict[str, Any]) -> tuple[int, int]:
    """(bytes as stored, bytes if everything were bf16): the
    device-memory traffic ratio a decode step should track."""
    stored = full = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            stored += leaf.q.numel() + leaf.scale.numel() * 4
            full += leaf.q.numel() * 2
        else:
            stored += leaf.numel() * leaf.element_size()
            full += leaf.numel() * 2
    return stored, full


__all__ = ["Int8Plan", "QTensor", "ein", "int8_bmm",
           "int8_bmm_reference", "int8_matmul", "int8_matmul_reference",
           "int8_plan", "int8_route", "launches", "pick_int8_tiles",
           "qeinsum", "quantize", "quantize_for", "quantize_params",
           "quantized_bytes", "scale_dims", "take_rows", "tc_launches"]
