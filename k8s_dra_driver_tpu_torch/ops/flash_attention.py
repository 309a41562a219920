"""Flash attention, forward and backward: the Hopper kernels K1, K3, K4
and their plain versions.

``flash_attention`` is the port of
``k8s_dra_driver_tpu/ops/flash_attention.py:flash_attention``: the
normalized forward through ``_flash_forward`` and the backward of its
``custom_vjp``, here a ``torch.autograd.Function``.

- Forward: on a CUDA tensor :func:`flash_forward` launches K1, which
  replaces the TPU kernel ``_flash_kernel`` (launched there by
  ``_flash_block_attention``), by the route :func:`fwd_route` picks
  from the dtype: bfloat16 on the tensor cores
  (``csrc/flash_fwd_sm90.cu``, wgmma), float32 on the CUDA cores
  (``csrc/flash_fwd.cu``).  On a CPU tensor it takes
  ``flash_forward_reference``, the plain version both routes are held
  against: q scaled and rounded to its dtype, and p rounded to v's
  dtype per key block of ``FWD_BLOCK_K`` (the kernel's key tile)
  against the running max, where the TPU kernel rounds them.
  ``attention_forward`` is its f32 oracle (nothing rounded).
- Block entry: :func:`flash_block_attention`, the port of the JAX
  ``flash_block_attention`` (``_flash_block_attention``): q
  ``[B, Tq, H, D]`` against one K/V block ``[B, Tk, H_kv, D]`` at
  absolute offsets, masks by absolute position, separate q and k
  segments, and the unnormalized statistics ``(o, m, l)`` in f32 that
  :func:`merge_flash_stats` folds across blocks (a ring hop).  The same
  two kernels run it in a second mode, the same routes; on CPU tensors
  it takes ``flash_block_attention_reference``, the plain version that
  rounds where ``_flash_kernel`` rounds.
- Backward: :func:`flash_block_grads`, the port of the JAX function of
  that name, launches K3 (:func:`flash_bwd_dq`, replacing
  ``_flash_bwd_dq_kernel``) and K4 (:func:`flash_bwd_dkv`, replacing
  ``_flash_bwd_dkv_kernel``) by the route :func:`bwd_route` picks from
  the dtype: bfloat16 on the tensor cores (``csrc/flash_bwd_sm90.cu``,
  wgmma), float32 on the CUDA cores (``csrc/flash_bwd.cu``).  On CPU
  tensors it takes ``flash_block_grads_reference``, the plain version
  both routes are held against: ``attention_block_grads`` (the port of
  the JAX oracle, all f32) with p and ds rounded to the input dtype
  before the second products, where the TPU kernels round them.  It
  recomputes the scores from the unrounded q times the scale, as the
  JAX package's ``_bwd_common`` does.

There is no other path: an unsupported shape or dtype on the card
raises.

The kernels take head dims 8, 16, 32, 64 and 128
(:data:`_KERNEL_HEAD_DIMS`; the small ones are the JAX package's probe
models), where the JAX kernels take any: another D raises.  K1's plan
(the route and its tiles) comes from :func:`pick_fwd_params`, through
the autotune table (``ops/autotune.py``), as K7's does; the kernels
have one plan a route.

``launches``, ``dq_launches`` and ``dkv_launches`` count kernel
launches of K1, K3 and K4 (CPU calls never count); ``tc_launches``,
``dq_tc_launches`` and ``dkv_tc_launches`` count those on the
tensor-core route.  ``block_launches`` and ``block_tc_launches`` count
K1's block-entry launches apart: ``launches`` counts only the
normalized entry.  ``dim_launches`` counts every launch again by
``(entry, dtype, head dim)``, entry one of ``flash_fwd``,
``flash_fwd_block``, ``flash_bwd_dq``, ``flash_bwd_dkv``.
"""

from __future__ import annotations

import torch

from ..utils.device import on_card
from . import _build, autotune
from .ring_attention import _NEG_INF, attention_mask, kv_group

#: kernel launches made by :func:`flash_forward` on CUDA tensors (K1)
launches = 0
#: launches of K3 (dq) by :func:`flash_bwd_dq`
dq_launches = 0
#: launches of K4 (dk/dv) by :func:`flash_bwd_dkv`
dkv_launches = 0
#: of those, the launches on the tensor-core route (bfloat16)
tc_launches = 0
dq_tc_launches = 0
dkv_tc_launches = 0
#: launches of K1's block entry by :func:`flash_block_attention`, and
#: of those the ones on the tensor-core route
block_launches = 0
block_tc_launches = 0
#: every launch of the four kernels by (entry, dtype name, head dim)
dim_launches: dict = {}

#: keys per tile of the tensor-core K1 (``csrc/flash_fwd_sm90.cu``); the
#: plain version walks the keys in blocks of this width by default, so
#: that it rounds p against the running max the kernel keeps
FWD_BLOCK_K = 128

#: the head dims the kernels take (the JAX kernels take any)
_KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
#: K1's one plan a route: query rows a block and keys a tile
#: (``csrc/flash_fwd_sm90.cu``, ``csrc/flash_fwd.cu``)
_FWD_PLANS = {"tensor_cores": dict(block_q=64, block_k=FWD_BLOCK_K),
              "cuda_cores": dict(block_q=64, block_k=64)}


def _count_dims(entry: str, dtype, d: int) -> None:
    key = (entry, str(dtype).removeprefix("torch."), d)
    dim_launches[key] = dim_launches.get(key, 0) + 1


def _validate(q, k, v, causal, window, segment_ids):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, T, H, D] and k/v matching [B, T, H_kv, D], "
            f"got {tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    kv_group(h, k.shape[2])
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and >= 1")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, t):
            raise ValueError(f"segment_ids must be [B, T] = {(b, t)}, "
                             f"got {tuple(segment_ids.shape)}")
        if segment_ids.device != q.device:
            raise ValueError("segment_ids must be on q's device")


def _require_contiguous(**tensors) -> None:
    for name, x in tensors.items():
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _require_int32(**tensors) -> None:
    for name, x in tensors.items():
        if x is not None and x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")


# --------------------------------------------------------------------------
# Forward (K1)
# --------------------------------------------------------------------------

def attention_forward(q, k, v, *, causal=True, scale=None, window=None,
                      segment_ids=None):
    """The f32 oracle of K1: ``(out, lse)`` with out ``[B, T, H, D]`` in
    q's dtype and lse ``[B, H, T]`` f32.  Scores scaled in f32, masked
    (-1e30), softmax and p in f32, nothing rounded before the final
    cast; GQA by repeat."""
    _validate(q, k, v, causal, window, segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = kv_group(q.shape[2], k.shape[2])
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = attention_mask(q.shape[1], causal, window, segment_ids,
                          q.device)
    s = s.masked_fill(~mask[:, None], _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return out, lse


def flash_forward_reference(q, k, v, *, causal=True, scale=None,
                            window=None, segment_ids=None,
                            block_k=FWD_BLOCK_K, out_dtype=None):
    """The plain version K1 is held against: ``(out, lse)`` with out
    ``[B, T, H, D]`` in ``out_dtype`` (default q's dtype) and lse
    ``[B, H, T]`` f32, rounded where the TPU kernel rounds.

    q is scaled in f32 and rounded to its dtype
    (``_flash_block_attention`` folds the scale into q).  The keys are
    walked in blocks of ``block_k`` from key 0, with the running max
    ``m`` and sum ``l`` in f32 and the kernel's masks (-1e30 fill, then
    ``where(mask, exp(s - m_new), 0)``); each block's p is rounded to
    v's dtype before p.v, as ``_flash_kernel`` does, and ``l`` sums the
    unrounded p.  Returns ``acc / l`` and ``lse = m + log(l)``.  The
    rounding of p depends on the running max, so on the key partition:
    ``block_k`` must be the kernel's key tile (the default) to hold the
    kernel, or the JAX call's ``block_k`` to hold that.  In f32 every
    rounding is a no-op and the result is :func:`attention_forward`'s
    to a few units in the last place.

    On the card the bf16 scores are summed on the tensor cores with f32
    accumulation (:func:`_first_product`), as the kernel sums them, so
    that p reaches its rounding with the same f32 values."""
    _validate(q, k, v, causal, window, segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, m, l = _flash_stats(q, k, v, 0, 0, causal, scale, window,
                           segment_ids, segment_ids, block_k)
    out, lse = normalize_flash_stats(o, m, l)
    return out.to(out_dtype or q.dtype), lse


def _flash_stats(q, k, v, q_offset, k_offset, causal, scale, window,
                 q_segments, k_segments, block_k):
    """The online softmax both plain versions share, rounded where
    ``_flash_kernel`` rounds: ``(o [B, Tq, H, D], m, l [B, H, Tq])`` f32,
    o unnormalized.  The keys are walked in blocks of ``block_k`` from
    the block's key 0; masks by absolute position (:func:`block_mask`).
    A row that sees no key keeps m = -1e30, l = 0, o = 0."""
    if block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    group = kv_group(h, k.shape[2])
    qs = (q.float() * scale).to(q.dtype)
    k = k.repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    on_tensor_cores = q.is_cuda and q.dtype == torch.bfloat16
    s = _first_product(qs if on_tensor_cores else qs.float(),
                       k if on_tensor_cores else k.float())
    mask = block_mask(tq, tk, q_offset, k_offset, causal, window, None,
                      q_segments, k_segments, q.device)
    if mask is not None:
        mask = mask[:, None]
        s = s.masked_fill(~mask, _NEG_INF)
    m = torch.full((b, h, tq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, tq, q.shape[3]), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, tk, block_k):
        sb = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, sb.amax(-1))
        p = torch.exp(sb - m_new[..., None])
        if mask is not None:
            p = torch.where(mask[..., k0:k0 + block_k], p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                          vf[:, k0:k0 + block_k])
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc.transpose(1, 2), m, l


def flash_attention_reference(q, k, v, *, causal=True, scale=None,
                              window=None, segment_ids=None):
    """The normalized output of :func:`flash_forward_reference`."""
    return flash_forward_reference(q, k, v, causal=causal, scale=scale,
                                   window=window,
                                   segment_ids=segment_ids)[0]


#: K1, K3 and K4 kernel route by input dtype
_ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}


def fwd_route(dtype, head_dim: int) -> str:
    """The route K1 takes on the card for inputs of ``dtype`` and head
    dim ``head_dim``: ``"tensor_cores"`` for bfloat16
    (``csrc/flash_fwd_sm90.cu``), ``"cuda_cores"`` for float32
    (``csrc/flash_fwd.cu``).  Raises for any other dtype or a head dim
    outside :data:`_KERNEL_HEAD_DIMS`: there is no fallback."""
    return _route(_ROUTES, "flash forward", dtype, head_dim)


def pick_fwd_params(tq: int, tk: int, head_dim: int, kv_group: int = 1,
                    window: int | None = None,
                    dtype=torch.bfloat16) -> dict:
    """K1's plan at a shape: ``route`` (:func:`fwd_route`), ``block_q``
    and ``block_k`` (query rows a block, keys a tile), from the autotune
    table (``ops/autotune.py``; kernel ``"flash_fwd"``,
    the JAX package's shape key ``d,g,tk,tq,w``), falling back to the
    route's plan.  Each route's kernel has one plan, so a table entry
    must name it or the pick raises ``ValueError``.  Host-only and
    cached per shape on the table; both entries of K1 take their route
    from it.  The port's counterpart of the JAX ``pick_fwd_params``,
    whose plans are the Pallas grid's blocks."""
    tuner = autotune.get_autotuner()

    def build() -> dict:
        route = fwd_route(dtype, head_dim)
        plan = dict(route=route, **_FWD_PLANS[route])
        key = autotune.shape_key(tq=tq, tk=tk, d=head_dim, g=kv_group,
                                 w=window or 0)
        choice = tuner.pick("flash_fwd", key, dtype, default=plan)
        if choice.params != plan:
            entry = autotune.table_key("flash_fwd", key, dtype,
                                       autotune.backend_key())
            raise ValueError(f"autotune entry {entry}: K1 has one plan on "
                             f"the {route} route, {plan}; got "
                             f"{choice.params}")
        return plan

    return dict(tuner.memo(("flash_fwd", tq, tk, head_dim, kv_group,
                            window, dtype), build))


def pick_blocks(tq: int, tk: int, head_dim: int) -> tuple[int, int]:
    """``(block_q, block_k)`` of :func:`pick_fwd_params` for bfloat16
    at this shape, as the JAX ``pick_blocks`` views its pick."""
    plan = pick_fwd_params(tq, tk, head_dim)
    return plan["block_q"], plan["block_k"]


def _route(routes, what: str, dtype, head_dim: int) -> str:
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the {what} kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {head_dim}")
    route = routes.get(dtype)
    if route is None:
        raise ValueError(f"the {what} kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    return route


def _launch(q, k, v, causal, scale, window, segment_ids, out_dtype):
    global launches, tc_launches
    b, t, h, d = q.shape
    plan = pick_fwd_params(t, t, d, h // k.shape[2], window, q.dtype)
    tc = plan["route"] == "tensor_cores"
    if out_dtype != q.dtype and not (tc and out_dtype == torch.float32):
        raise ValueError(f"the flash forward kernel writes q's dtype"
                         f"{' or float32' if tc else ''}, not {out_dtype}")
    _require_contiguous(q=q, k=k, v=v, segment_ids=segment_ids)
    _require_int32(segment_ids=segment_ids)
    # the tensor-core kernel takes the output's dtype code (its inputs
    # are bf16), the CUDA-core one the inputs'
    code = _build.DTYPE_CODES[str(out_dtype).removeprefix("torch.")]
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    name = "flash_fwd_tc" if tc else "flash_fwd"
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            segment_ids.data_ptr() if segment_ids is not None else None,
            out.data_ptr(), lse.data_ptr(), b, t, h, k.shape[2], d,
            int(causal), int(window or 0), float(scale), code, stream)
    _build.check(rc, name)
    launches += 1
    tc_launches += tc
    _count_dims("flash_fwd", q.dtype, d)
    return out, lse


def flash_forward(q, k, v, *, causal=True, scale=None, window=None,
                  segment_ids=None, out_dtype=None):
    """``(out, lse)``: K1 on CUDA tensors, by the route
    :func:`fwd_route` picks, and the plain version
    :func:`flash_forward_reference` on CPU tensors.  q ``[B, T, H, D]``,
    k/v ``[B, T, H_kv, D]`` (float32 or bfloat16, contiguous and
    16-byte aligned on the card, D in :data:`_KERNEL_HEAD_DIMS`),
    ``segment_ids``
    [B, T] int32.  ``out_dtype`` (default q's dtype) may be float32
    for bfloat16 inputs: the output before its final rounding."""
    _validate(q, k, v, causal, window, segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_card(q, "flash_forward"):
        return flash_forward_reference(q, k, v, causal=causal,
                                       scale=scale, window=window,
                                       segment_ids=segment_ids,
                                       out_dtype=out_dtype)
    return _launch(q, k, v, causal, scale, window, segment_ids,
                   out_dtype or q.dtype)


# --------------------------------------------------------------------------
# K1's block entry: q against one K/V block at absolute offsets
# --------------------------------------------------------------------------

def _validate_block(q, k, v, causal, window, q_segments, k_segments):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, Tq, H, D] and k/v matching [B, Tk, H_kv, D], "
            f"got {tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    b, tq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    kv_group(h, k.shape[2])
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and >= 1")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if (q_segments is None) != (k_segments is None):
        raise ValueError("q_segments and k_segments must be given "
                         "together")
    if q_segments is not None:
        if (tuple(q_segments.shape) != (b, tq)
                or tuple(k_segments.shape) != (b, k.shape[1])):
            raise ValueError("q_segments must be [B, Tq] and k_segments "
                             "[B, Tk]")
        if (q_segments.device != q.device
                or k_segments.device != q.device):
            raise ValueError("segments must be on q's device")


def flash_block_attention_reference(q, k, v, q_offset, k_offset, *,
                                    causal=True, scale=None, window=None,
                                    q_segments=None, k_segments=None,
                                    block_k=FWD_BLOCK_K):
    """The plain version of K1's block entry: ``(o, m, l)`` as
    :func:`flash_block_attention` returns them, rounded where
    ``_flash_kernel`` rounds (q scaled in f32 and rounded to its dtype;
    each key block's p rounded to v's dtype against the running max),
    the keys walked from the block's key 0 in blocks of ``block_k``
    (the kernel's key tile by default; the JAX call's ``block_k`` to
    hold that).  Rows that see no key of the block come out as
    m = -1e30, l = 0, o = 0.  ``flash_forward_reference`` is its
    normalized special case (offsets 0, Tq = Tk, one segment array)."""
    _validate_block(q, k, v, causal, window, q_segments, k_segments)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, m, l = _flash_stats(q, k, v, int(q_offset), int(k_offset), causal,
                           scale, window, q_segments, k_segments, block_k)
    return o.contiguous(), m, l


def _launch_block(q, k, v, q_offset, k_offset, causal, scale, window,
                  q_segments, k_segments):
    global block_launches, block_tc_launches
    b, tq, h, d = q.shape
    tk = k.shape[1]
    plan = pick_fwd_params(tq, tk, d, h // k.shape[2], window, q.dtype)
    tc = plan["route"] == "tensor_cores"
    _require_contiguous(q=q, k=k, v=v, q_segments=q_segments,
                        k_segments=k_segments)
    _require_int32(q_segments=q_segments, k_segments=k_segments)
    code = _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")]
    o = torch.empty((b, tq, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    name = "flash_fwd_block_tc" if tc else "flash_fwd_block"
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_segments.data_ptr() if q_segments is not None else None,
            k_segments.data_ptr() if k_segments is not None else None,
            o.data_ptr(), m.data_ptr(), l.data_ptr(), b, tq, tk, h,
            k.shape[2], d, int(q_offset), int(k_offset), int(causal),
            int(window or 0), float(scale), code, stream)
    _build.check(rc, name)
    block_launches += 1
    block_tc_launches += tc
    _count_dims("flash_fwd_block", q.dtype, d)
    return o, m, l


def flash_block_attention(q, k, v, q_offset, k_offset, *, causal=True,
                          scale=None, window=None, q_segments=None,
                          k_segments=None):
    """Unnormalized flash attention of q against one K/V block: the
    port of the JAX ``flash_block_attention``.

    q ``[B, Tq, H, D]``; k/v ``[B, Tk, H_kv, D]`` with H a multiple of
    H_kv (GQA by head index); ``q_offset``/``k_offset`` the blocks'
    absolute positions, against which the causal and ``window`` masks
    compare; ``q_segments``/``k_segments`` ([B, Tq] / [B, Tk] int32,
    both or neither) mask packed sequences.  Returns f32 ``(o [B, Tq,
    H, D] unnormalized, m [B, H, Tq], l [B, H, Tq])``, the flash
    statistics :func:`merge_flash_stats` folds with other blocks'; a row
    that sees no key of the block has m = -1e30, l = 0, o = 0.

    On CUDA tensors K1 runs in its block mode by the route
    :func:`fwd_route` picks (bf16 on the tensor cores, f32 on the CUDA
    cores; contiguous, 16-byte aligned, D in :data:`_KERNEL_HEAD_DIMS`);
    on CPU tensors
    the plain version :func:`flash_block_attention_reference`.  The TPU
    call's grid knobs (``block_q``, ``block_k``, ``narrow_window``,
    ``kv_reuse``, ``interpret``) have no counterpart: the CUDA kernels
    fix their own tiles and skip key tiles by position."""
    _validate_block(q, k, v, causal, window, q_segments, k_segments)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_card(q, "flash_block_attention"):
        return flash_block_attention_reference(
            q, k, v, q_offset, k_offset, causal=causal, scale=scale,
            window=window, q_segments=q_segments, k_segments=k_segments)
    return _launch_block(q, k, v, q_offset, k_offset, causal, scale,
                         window, q_segments, k_segments)


def merge_flash_stats(o, m, l, o_blk, m_blk, l_blk):
    """Merge a block's ``(o_unnorm, m, l)`` into the running statistics:
    the cross-block half of the online softmax (a ring hop's merge), as
    the JAX ``merge_flash_stats``.  o/o_blk ``[B, Tq, H, D]`` f32; m/l
    ``[B, H, Tq]`` f32."""
    m_new = torch.maximum(m, m_blk)
    corr = torch.exp(m - m_new)
    corr_blk = torch.exp(m_blk - m_new)
    l_new = l * corr + l_blk * corr_blk
    o_new = (o * corr.transpose(1, 2)[..., None]
             + o_blk * corr_blk.transpose(1, 2)[..., None])
    return o_new, m_new, l_new


# --------------------------------------------------------------------------
# Backward (K3, K4) against one K/V block
# --------------------------------------------------------------------------

def block_mask(tq: int, tk: int, q_offset: int, k_offset: int,
               causal: bool, window=None, k_valid_end=None,
               q_segments=None, k_segments=None, device=None):
    """``[1|B, Tq, Tk]`` bool, True where query row may see key column
    of one block: causal and sliding ``window`` by absolute position
    (the blocks start at ``q_offset``/``k_offset``), keys at absolute
    positions >= ``k_valid_end`` dropped, segment equality.  None when
    nothing is masked."""
    k_pos = k_offset + torch.arange(tk, device=device)
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(tq, device=device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
    if k_valid_end is not None:
        valid = (k_pos < k_valid_end)[None, :].expand(tq, tk)
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        mask = mask[None]
    if q_segments is not None:
        seg = q_segments[:, :, None] == k_segments[:, None, :]
        mask = seg if mask is None else (mask & seg)
    return mask


def attention_block_grads(q, k, v, do, delta, lse, q_offset, k_offset,
                          causal: bool, scale: float,
                          k_valid_end: int | None = None,
                          window: int | None = None,
                          q_segments=None, k_segments=None):
    """Flash backward against one K/V block, plain PyTorch in f32: the
    port of the JAX package's ``attention_block_grads``, the oracle of
    K3 and K4.

    q/do ``[B, Tq, H, D]``; k/v ``[B, Tk, H_kv, D]``; delta ``[B, H,
    Tq]`` = rowsum(do * o) with o the normalized output; lse ``[B, H,
    Tq]`` = m + log(l) over the FULL key range.  Offsets are the blocks'
    absolute positions.  Returns f32 ``(dq, dk, dv)``: dq this block's
    partial sum, dk/dv complete for this block and summed over each K/V
    head's query heads.  p = exp(s - lse); dv = p^T do; dp = do v^T;
    ds = p * (dp - delta) * scale; dq = ds k; dk = ds^T q.
    """
    return _block_grads(q, k, v, do, delta, lse, q_offset, k_offset, causal,
                        scale, k_valid_end, window, q_segments, k_segments,
                        torch.float32)


def flash_block_grads_reference(q, k, v, do, delta, lse, q_offset,
                                k_offset, causal: bool, scale: float,
                                k_valid_end: int | None = None,
                                window: int | None = None,
                                q_segments=None, k_segments=None):
    """The plain version K3 and K4 are held against: the f32 sums of
    :func:`attention_block_grads` (same arguments and result), except
    that p and ds are rounded to q's dtype just before the second
    products (dv = p^T do, dq = ds k, dk = ds^T q), where the TPU
    kernels round them (``p.astype(dof.dtype)``, ``ds.astype(kf.dtype)``,
    ``ds.astype(qf.dtype)``) and where a bf16 tensor-core product takes
    them.  In f32 the rounding does nothing: the result equals
    :func:`attention_block_grads` bit for bit.

    On the card, bf16 scores and dp (the first products) are summed on
    the tensor cores with f32 accumulation (``torch.bmm`` with
    ``out_dtype=torch.float32``), in k16 steps as the kernels' wgmma
    sums them, so that p and ds reach their bf16 rounding with the same
    f32 values: two f32 sums of the same exact products in different
    orders part by a few units in the last place, and one such unit can
    move p or ds to the neighbouring bf16 value, a step of 2^-8 of it
    in every product it enters.  On the CPU they are f32 einsums."""
    return _block_grads(q, k, v, do, delta, lse, q_offset, k_offset, causal,
                        scale, k_valid_end, window, q_segments, k_segments,
                        q.dtype)


def _block_grads(q, k, v, do, delta, lse, q_offset, k_offset, causal,
                 scale, k_valid_end, window, q_segments, k_segments,
                 operand_dtype):
    """Both plain versions: p and ds enter the second products rounded
    to ``operand_dtype`` (f32: not rounded)."""
    if (q_segments is None) != (k_segments is None):
        raise ValueError("q_segments and k_segments must be given "
                         "together")
    h = q.shape[2]
    h_kv = k.shape[2]
    group = kv_group(h, h_kv)
    if group > 1:     # GQA: broadcast kv heads; dk/dv group-summed below
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    on_tensor_cores = q.is_cuda and operand_dtype == torch.bfloat16
    s = _first_product(q if on_tensor_cores else qf,
                       k if on_tensor_cores else kf) * scale
    p = torch.exp(s - lse[..., None])
    tq, tk = q.shape[1], k.shape[1]
    mask = block_mask(tq, tk, q_offset, k_offset, causal, window,
                      k_valid_end, q_segments, k_segments, q.device)
    if mask is not None:
        p = torch.where(mask[:, None], p, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(operand_dtype).float(), dof)
    dp = _first_product(do if on_tensor_cores else dof,
                        v if on_tensor_cores else vf)
    ds = p * (dp - delta[..., None]) * scale
    ds = ds.to(operand_dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if group > 1:     # fold each group's contributions into its kv head
        b, d = q.shape[0], q.shape[3]
        dk = dk.reshape(b, tk, h_kv, group, d).sum(3)
        dv = dv.reshape(b, tk, h_kv, group, d).sum(3)
    return dq, dk, dv


def _first_product(x, y):
    """``[B, Tq, H, D]`` x ``[B, Tk, H, D]`` -> ``[B, H, Tq, Tk]`` f32,
    summed over D: an f32 einsum for f32 operands, one tensor-core
    product with f32 accumulation for bf16 ones (on the card only)."""
    if x.dtype == torch.float32:
        return torch.einsum("bqhd,bkhd->bhqk", x, y)
    b, tq, h, d = x.shape
    tk = y.shape[1]
    xs = x.transpose(1, 2).reshape(b * h, tq, d)
    ys = y.permute(0, 2, 3, 1).reshape(b * h, d, tk)
    return torch.bmm(xs, ys, out_dtype=torch.float32).reshape(b, h, tq, tk)


def _validate_bwd(q, k, v, do, delta, lse, window, causal, q_segments,
                  k_segments):
    """The block entry's contract (:func:`_validate_block`), and do,
    delta and lse matching q."""
    _validate_block(q, k, v, causal, window, q_segments, k_segments)
    b, tq, h, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    for name, x in (("delta", delta), ("lse", lse)):
        if tuple(x.shape) != (b, h, tq) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B, H, Tq] = "
                             f"{(b, h, tq)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if do.dtype != q.dtype:
        raise ValueError("q, k, v and do must share one dtype")
    if len({x.device for x in (q, do, delta, lse)}) != 1:
        raise ValueError("q, k, v, do, delta and lse must be on one "
                         "device")


def bwd_route(dtype, head_dim: int) -> str:
    """The route K3 and K4 take on the card for inputs of ``dtype`` and
    head dim ``head_dim``: ``"tensor_cores"`` for bfloat16
    (``csrc/flash_bwd_sm90.cu``), ``"cuda_cores"`` for float32
    (``csrc/flash_bwd.cu``).  Raises for any other dtype or a head dim
    outside :data:`_KERNEL_HEAD_DIMS`: there is no fallback."""
    return _route(_ROUTES, "flash backward", dtype, head_dim)


def _bwd_launch_args(q, k, v, do, delta, lse, q_offset, k_offset, causal,
                     scale, k_valid_end, window, q_segments, k_segments):
    """Checks what the kernels take; returns the route and the C
    arguments shared by K3 and K4, after the output pointers."""
    route = bwd_route(q.dtype, q.shape[-1])
    code = _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")]
    _require_contiguous(q=q, k=k, v=v, do=do, delta=delta, lse=lse,
                        q_segments=q_segments, k_segments=k_segments)
    _require_int32(q_segments=q_segments, k_segments=k_segments)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    # keys at absolute positions >= k_valid_end are masked: the kernels
    # take the count of valid local keys
    k_len = tk if k_valid_end is None else max(
        0, min(tk, int(k_valid_end) - int(k_offset)))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(),
              q_segments.data_ptr() if q_segments is not None else None,
              k_segments.data_ptr() if k_segments is not None else None)
    sizes = (b, tq, tk, k_len, h, k.shape[2], d, int(q_offset),
             int(k_offset), int(causal), int(window or 0), float(scale),
             code)
    return route, inputs, sizes


def _launch_bwd(dq_pass: bool, *args):
    """Launch K3 (``dq_pass``; returns dq) or K4 (returns ``(dk, dv)``)
    on ``args``, the positional arguments of
    :func:`attention_block_grads`, after checking what the kernels
    take."""
    global dq_launches, dkv_launches, dq_tc_launches, dkv_tc_launches
    q, k = args[0], args[1]
    route, inputs, sizes = _bwd_launch_args(*args)
    tc = route == "tensor_cores"
    shapes = [q.shape] if dq_pass else [k.shape, k.shape]
    outs = [torch.empty(shape, dtype=torch.float32, device=q.device)
            for shape in shapes]
    name = ("flash_bwd_dq" if dq_pass else "flash_bwd_dkv") + (
        "_tc" if tc else "")
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(*inputs, *(o.data_ptr() for o in outs),
                                *sizes, stream)
    _build.check(rc, name)
    _count_dims("flash_bwd_dq" if dq_pass else "flash_bwd_dkv", q.dtype,
                q.shape[-1])
    if dq_pass:
        dq_launches += 1
        dq_tc_launches += tc
        return outs[0]
    dkv_launches += 1
    dkv_tc_launches += tc
    return outs[0], outs[1]


def _bwd_args(q, k, v, do, delta, lse, q_offset, k_offset, causal, scale,
              k_valid_end, window, q_segments, k_segments):
    """Validated positional arguments of :func:`attention_block_grads`,
    the scale defaulted."""
    _validate_bwd(q, k, v, do, delta, lse, window, causal, q_segments,
                  k_segments)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return (q, k, v, do, delta, lse, q_offset, k_offset, causal, scale,
            k_valid_end, window, q_segments, k_segments)


def flash_bwd_dq(q, k, v, do, delta, lse, q_offset=0, k_offset=0, *,
                 causal=True, scale=None, k_valid_end=None, window=None,
                 q_segments=None, k_segments=None):
    """dq ``[B, Tq, H, D]`` f32 of :func:`flash_block_grads_reference`
    (same arguments): K3 on CUDA tensors, the plain version on CPU
    tensors."""
    args = _bwd_args(q, k, v, do, delta, lse, q_offset, k_offset, causal,
                     scale, k_valid_end, window, q_segments, k_segments)
    if not on_card(q, "flash_bwd_dq"):
        return flash_block_grads_reference(*args)[0]
    return _launch_bwd(True, *args)


def flash_bwd_dkv(q, k, v, do, delta, lse, q_offset=0, k_offset=0, *,
                  causal=True, scale=None, k_valid_end=None, window=None,
                  q_segments=None, k_segments=None):
    """``(dk, dv)``, each ``[B, Tk, H_kv, D]`` f32, of
    :func:`flash_block_grads_reference`: K4 on CUDA tensors, which sums
    over the query heads of each K/V head inside the kernel (no atomics,
    no per-query-head intermediate); the plain version on CPU tensors."""
    args = _bwd_args(q, k, v, do, delta, lse, q_offset, k_offset, causal,
                     scale, k_valid_end, window, q_segments, k_segments)
    if not on_card(q, "flash_bwd_dkv"):
        return flash_block_grads_reference(*args)[1:]
    return _launch_bwd(False, *args)


def flash_block_grads(q, k, v, do, delta, lse, q_offset=0, k_offset=0, *,
                      causal=True, scale=None, k_valid_end=None,
                      window=None, q_segments=None, k_segments=None):
    """f32 ``(dq, dk, dv)`` of one K/V block, the contract of
    :func:`attention_block_grads`: K3 and K4 on CUDA tensors, the plain
    version :func:`flash_block_grads_reference` on CPU tensors."""
    args = _bwd_args(q, k, v, do, delta, lse, q_offset, k_offset, causal,
                     scale, k_valid_end, window, q_segments, k_segments)
    if not on_card(q, "flash_block_grads"):
        return flash_block_grads_reference(*args)
    return (_launch_bwd(True, *args), *_launch_bwd(False, *args))


def normalize_flash_stats(o, m, l):
    """Flash epilogue: (o_unnorm ``[B, Tq, H, D]``, m, l ``[B, H, Tq]``)
    -> (o normalized f32, lse), with the l-clamp of the JAX package."""
    l = torch.clamp(l, min=1e-30)
    out = o / l.transpose(1, 2)[..., None]
    return out, m + torch.log(l)


def attention_delta(do, out):
    """delta_i = rowsum(do_i * o_i), the softmax-jacobian correction
    term of the flash backward; [B,Tq,H,D] x2 -> [B,H,Tq] f32."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), out.float())


def flash_backward(q, k, v, out, lse, do, *, causal=True, scale=None,
                   window=None, segment_ids=None):
    """f32 ``(dq, dk, dv)`` of :func:`flash_attention` from its saved
    forward (``out``, ``lse``) and the output gradient ``do``: delta in
    plain torch, then K3 and K4 on the card (the plain version on the
    CPU)."""
    delta = attention_delta(do, out)
    return flash_block_grads(q, k, v, do.contiguous(), delta, lse, 0, 0,
                             causal=causal, scale=scale, window=window,
                             q_segments=segment_ids,
                             k_segments=segment_ids)


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX ``_flash_attention``: forward saves
    q, k, v, out and lse; backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale, window):
        out, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                                 window=window, segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do,
                                    causal=ctx.causal, scale=ctx.scale,
                                    window=ctx.window,
                                    segment_ids=segment_ids)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None, None, None)


def flash_attention(q, k, v, *, causal=True, scale=None, window=None,
                    segment_ids=None):
    """Single-device flash attention, normalized and differentiable:
    ``[B, T, H, D]`` in q's dtype.  Same masks as
    ``attention_reference``: causal, sliding ``window``,
    ``segment_ids`` packing, GQA by K/V head index.  Gradients flow to
    q, k and v through K3 and K4 on the card."""
    return _FlashAttention.apply(q, k, v, segment_ids, causal, scale,
                                 window)


__all__ = ["FWD_BLOCK_K", "attention_block_grads", "attention_delta",
           "attention_forward", "block_mask", "bwd_route",
           "flash_attention", "flash_attention_reference",
           "flash_backward", "flash_block_attention",
           "flash_block_attention_reference", "flash_block_grads",
           "flash_block_grads_reference", "flash_bwd_dkv",
           "flash_bwd_dq", "flash_forward", "flash_forward_reference",
           "fwd_route", "merge_flash_stats", "normalize_flash_stats",
           "pick_blocks", "pick_fwd_params"]
