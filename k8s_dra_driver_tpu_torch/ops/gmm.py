"""Grouped matmul: the sparse-MoE expert kernels K5 (gmm) and K6 (gmm
dw) for Hopper, and their plain versions.

The port of ``k8s_dra_driver_tpu/ops/gmm.py``.  ``gmm(x, w,
group_sizes, block_m)`` multiplies row group ``e`` of ``x`` [M, K] by
expert matrix ``w[e]`` [E, K, N]: rows are sorted by expert and every
group is padded to a ``block_m`` multiple by the routing layer
(``models/transformer.py:_gmm_dispatch_combine``), so each row block
belongs to one expert.  Blocks at or past the live count (the sum of
the group sizes over ``block_m``) are the static row bound's dead tail:
their output rows are zero.

- Forward and dx: on CUDA tensors :func:`gmm_forward` launches K5,
  which replaces both Pallas bodies ``_gmm_whole_kernel`` and
  ``_gmm_kernel`` (launched there by ``_gmm_impl``), by the route
  :func:`gmm_route` picks from the dtype: bfloat16 on the tensor cores
  (``csrc/gmm_sm90.cu`` ``gmm_sm90_kernel``, wgmma; ``block_m`` 128,
  K a multiple of :data:`TC_TILE_K`, N of :data:`TC_TILE_N`), float32
  on the CUDA cores (``csrc/gmm.cu`` ``gmm_kernel``).  ``transpose_w``
  reads ``w`` as ``[E, N, K]`` for dx, so no transposed copy of the
  experts is made.  The JAX kernels round nothing between the
  products, so :func:`gmm_reference` is the plain version of both
  routes.
- dw: :func:`gmm_dw` launches K6, which replaces ``_gmm_dw_kernel``
  (launched there by ``_gmm_dw``), by the route :func:`dw_route` picks
  from the dtype: bfloat16 on the tensor cores (``csrc/gmm_dw_sm90.cu``
  ``gmm_dw_sm90_kernel``, wgmma with both operands through the
  transpose bits; ``block_m`` 128, K and N multiples of
  :data:`TC_DW_TILE`), float32 on the CUDA cores (``csrc/gmm.cu``
  ``gmm_dw_kernel``).  f32 output, exact zeros for experts without
  rows; the backward asks the tensor-core route for w's dtype directly
  (``out_dtype``), the f32 sums rounded once.
- On CPU tensors both take their plain versions,
  :func:`gmm_reference` and :func:`gmm_dw_reference`.  There is no
  other path: an unsupported dtype or layout on the card raises.

Both kernels read the per-block expert ids and the live block count
from device memory (the CUDA form of the Pallas scalar prefetch), so
routing never reads group sizes back to the host.

``launches`` counts kernel launches by name (``"gmm"``, ``"gmm_dw"``);
``tc_launches`` and ``dw_tc_launches`` count the K5 and K6 launches on
the tensor-core route; CPU calls never count.
"""

from __future__ import annotations

import torch

from ..utils.device import on_card
from . import _build

#: kernel launches on CUDA tensors: K5 (``"gmm"``) and K6 (``"gmm_dw"``)
launches = {"gmm": 0, "gmm_dw": 0}
#: of K5's launches, those on the tensor-core route (bfloat16)
tc_launches = 0
#: of K6's launches, those on the tensor-core route (bfloat16)
dw_tc_launches = 0

#: rows of the CUDA-core K5's output tile; ``block_m`` must be a
#: multiple of it, so that no tile straddles two experts
TILE_M = 64

#: the tensor-core K5's tile: ``block_m`` rows (one expert), K in steps
#: of TC_TILE_K, N in TC_TILE_N columns
TC_BLOCK_M = 128
TC_TILE_K = 64
TC_TILE_N = 128

#: the tensor-core K6's output tile: K and N in TC_DW_TILE columns
#: (``block_m`` TC_BLOCK_M, so every 64-row step lies in one expert)
TC_DW_TILE = 128

#: K5 and K6 kernel route by input dtype
_ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}


def _round_up(n, k: int):
    """``n`` rounded up to a multiple of ``k`` (an int, or an integer
    tensor elementwise)."""
    return -(-n // k) * k


def _block_experts(group_sizes: torch.Tensor, n_blocks: int,
                   block_m: int) -> torch.Tensor:
    """Expert id of each row block ([n_blocks] int32).  Requires every
    group size to be a multiple of ``block_m`` (the routing layer pads
    groups), so no block straddles two experts; blocks beyond the last
    group clamp to the final expert."""
    ends = torch.cumsum(group_sizes, 0)
    starts = torch.arange(n_blocks, dtype=ends.dtype,
                          device=ends.device) * block_m
    eb = torch.searchsorted(ends, starts, right=True)
    return torch.clamp(eb, max=group_sizes.shape[0] - 1).to(torch.int32)


def _live_blocks(group_sizes: torch.Tensor, block_m: int) -> torch.Tensor:
    """[1] int32: the row blocks that hold routed rows (groups are
    padded to ``block_m`` multiples, so this is exact)."""
    return (group_sizes.sum() // block_m).to(torch.int32).reshape(1)


def pick_gmm_blocks(k_dim: int, n_dim: int, n_experts: int,
                    dtype=torch.bfloat16, rows: int | None = None) -> dict:
    """Grouped-matmul row block ``{"block_m": 128}`` for every shape.

    K5 looks up one expert per output tile: the CUDA-core route's tiles
    are 64 rows (``block_m`` a multiple of :data:`TILE_M`), the
    tensor-core route's :data:`TC_BLOCK_M` = 128, which it requires;
    128 also bounds each expert's padding at 127 rows.  K5 re-reads an
    expert's weights once per row tile whatever ``block_m`` is, so the
    JAX package's larger blocks for experts too big for VMEM buy nothing
    here.  The arguments mirror the JAX picker's; its v5e autotune table
    is never read (an H100 table is later work).  The routing layer must
    pad group sizes to the ``block_m`` returned."""
    del k_dim, n_dim, n_experts, dtype, rows
    return {"block_m": TC_BLOCK_M}


def _check(x, w, group_sizes, block_m, transpose_w):
    if x.ndim != 2 or w.ndim != 3:
        raise ValueError(f"x must be [M, K] and w [E, K, N], got "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")
    k_w, n_w = ((w.shape[2], w.shape[1]) if transpose_w
                else (w.shape[1], w.shape[2]))
    if x.shape[1] != k_w:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w})")
    if group_sizes.ndim != 1 or group_sizes.shape[0] != w.shape[0]:
        raise ValueError(f"group_sizes must be [E] = [{w.shape[0]}], got "
                         f"{tuple(group_sizes.shape)}")
    if x.shape[0] % block_m:
        raise ValueError(f"rows {x.shape[0]} not a multiple of block_m "
                         f"{block_m}")
    return n_w


def _kernel_args(x, others, group_sizes, block_m, what):
    """Checks what the kernels take; returns (dtype code, int32 group
    sizes on x's device)."""
    code = _build.DTYPE_CODES.get(str(x.dtype).removeprefix("torch."))
    if code is None:
        raise ValueError(f"the {what} kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    for name, t in others.items():
        if t.dtype != x.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
    for name, t in dict(x=x, **others).items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if block_m % TILE_M:
        raise ValueError(f"the {what} kernel takes block_m a multiple of "
                         f"{TILE_M}, got {block_m}")
    if group_sizes.device != x.device:
        raise ValueError(f"{what}: group_sizes must be on x's device")
    return code, group_sizes.to(torch.int32)


# --------------------------------------------------------------------------
# K5: out[block i] = x[block i] @ w[eb[i]]
# --------------------------------------------------------------------------

def gmm_route(dtype) -> str:
    """The route K5 takes on the card for inputs of ``dtype``:
    ``"tensor_cores"`` for bfloat16 (``csrc/gmm_sm90.cu``),
    ``"cuda_cores"`` for float32 (``csrc/gmm.cu``).  Raises for any
    other dtype: there is no fallback."""
    route = _ROUTES.get(dtype)
    if route is None:
        raise ValueError(f"the gmm kernel takes float32 or bfloat16, got "
                         f"{dtype}")
    return route


def _tc_args(x, w, block_m: int, n_dim: int) -> None:
    """What the tensor-core K5 takes, beyond :func:`_kernel_args`: one
    expert per ``TC_BLOCK_M``-row tile, K and N whole tiles (no ragged
    edge), bfloat16 x and w."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core gmm kernel takes bfloat16 x "
                         f"and w, got {x.dtype} / {w.dtype}")
    if block_m != TC_BLOCK_M:
        raise ValueError(f"the tensor-core gmm kernel takes block_m "
                         f"{TC_BLOCK_M}, got {block_m}")
    if x.shape[1] % TC_TILE_K or n_dim % TC_TILE_N:
        raise ValueError(f"the tensor-core gmm kernel takes K a multiple "
                         f"of {TC_TILE_K} and N of {TC_TILE_N}, got K="
                         f"{x.shape[1]} N={n_dim}")


def gmm_reference(x, w, group_sizes, block_m: int = 128,
                  transpose_w: bool = False):
    """Plain PyTorch version of K5: per-block products in f32 against
    each block's expert (w cast to x's dtype first, as the JAX kernel
    does), cast to x's dtype; dead-tail blocks zero.  No host loop over
    the group sizes: the expert weights are gathered per block."""
    n_dim = _check(x, w, group_sizes, block_m, transpose_w)
    m, k_dim = x.shape
    n_blocks = m // block_m
    eb = _block_experts(group_sizes, n_blocks, block_m).long()
    live = (torch.arange(n_blocks, device=x.device)
            < _live_blocks(group_sizes, block_m))
    wf = w.to(x.dtype).float()
    if transpose_w:
        wf = wf.transpose(1, 2)
    out = torch.bmm(x.float().reshape(n_blocks, block_m, k_dim), wf[eb])
    out = torch.where(live[:, None, None], out, 0.0)
    return out.reshape(m, n_dim).to(x.dtype)


def _launch_gmm(x, w, group_sizes, block_m, transpose_w, n_dim):
    global tc_launches
    tc = gmm_route(x.dtype) == "tensor_cores"
    code, gs = _kernel_args(x, {"w": w}, group_sizes, block_m, "gmm")
    if tc:
        _tc_args(x, w, block_m, n_dim)
    m, k_dim = x.shape
    eb = _block_experts(gs, m // block_m, block_m)
    nu = _live_blocks(gs, block_m)
    out = torch.empty((m, n_dim), dtype=x.dtype, device=x.device)
    name = "gmm_tc" if tc else "gmm"
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, name)(
            x.data_ptr(), w.data_ptr(), eb.data_ptr(), nu.data_ptr(),
            out.data_ptr(), m, k_dim, n_dim, w.shape[0], block_m,
            int(transpose_w), code, stream)
    _build.check(rc, name)
    launches["gmm"] += 1
    tc_launches += tc
    return out


def gmm_forward(x, w, group_sizes, block_m: int = 128,
                transpose_w: bool = False):
    """``[M, N]`` in x's dtype: K5 on CUDA tensors, by the route
    :func:`gmm_route` picks, the plain version on CPU tensors.  ``w`` is
    ``[E, K, N]``, or ``[E, N, K]`` read transposed with
    ``transpose_w``; on the card x and w share one dtype (float32 or
    bfloat16) and are contiguous."""
    n_dim = _check(x, w, group_sizes, block_m, transpose_w)
    if not on_card(x, "gmm"):
        return gmm_reference(x, w, group_sizes, block_m, transpose_w)
    return _launch_gmm(x, w, group_sizes, block_m, transpose_w, n_dim)


# --------------------------------------------------------------------------
# K6: dw[e] = x_e^T @ dy_e
# --------------------------------------------------------------------------

def _check_dw(x, dy, group_sizes, block_m):
    if x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"x must be [M, K] and dy [M, N], got "
                         f"{tuple(x.shape)} / {tuple(dy.shape)}")
    if group_sizes.ndim != 1:
        raise ValueError("group_sizes must be [E]")
    if x.shape[0] % block_m:
        raise ValueError(f"rows {x.shape[0]} not a multiple of block_m "
                         f"{block_m}")


def gmm_dw_reference(x, dy, group_sizes, block_m: int = 128):
    """Plain PyTorch version of K6: ``dw[e] = x_e^T dy_e`` [E, K, N] f32
    over expert e's live row blocks (dy cast to x's dtype first, as the
    JAX kernel does); experts without rows are exactly 0."""
    _check_dw(x, dy, group_sizes, block_m)
    m, k_dim = x.shape
    e = group_sizes.shape[0]
    n_blocks = m // block_m
    eb = _block_experts(group_sizes, n_blocks, block_m).long()
    live = (torch.arange(n_blocks, device=x.device)
            < _live_blocks(group_sizes, block_m))
    xb = x.float().reshape(n_blocks, block_m, k_dim)
    dyb = dy.to(x.dtype).float().reshape(n_blocks, block_m, dy.shape[1])
    per_block = torch.bmm(xb.transpose(1, 2), dyb)       # [blocks, K, N]
    owner = ((eb[:, None] == torch.arange(e, device=x.device))
             & live[:, None]).float()                    # [blocks, E]
    return torch.einsum("be,bkn->ekn", owner, per_block)


def dw_route(dtype) -> str:
    """The route K6 takes on the card for inputs of ``dtype``:
    ``"tensor_cores"`` for bfloat16 (``csrc/gmm_dw_sm90.cu``),
    ``"cuda_cores"`` for float32 (``csrc/gmm.cu``).  Raises for any
    other dtype: there is no fallback."""
    route = _ROUTES.get(dtype)
    if route is None:
        raise ValueError(f"the gmm_dw kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    return route


def _tc_dw_args(x, dy, block_m: int) -> None:
    """What the tensor-core K6 takes, beyond :func:`_kernel_args`: one
    expert per ``TC_BLOCK_M``-row block, K and N whole tiles of
    :data:`TC_DW_TILE` (no ragged edge), bfloat16 x and dy."""
    if x.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core gmm_dw kernel takes bfloat16 x "
                         f"and dy, got {x.dtype} / {dy.dtype}")
    if block_m != TC_BLOCK_M:
        raise ValueError(f"the tensor-core gmm_dw kernel takes block_m "
                         f"{TC_BLOCK_M}, got {block_m}")
    if x.shape[1] % TC_DW_TILE or dy.shape[1] % TC_DW_TILE:
        raise ValueError(f"the tensor-core gmm_dw kernel takes K and N "
                         f"multiples of {TC_DW_TILE}, got K={x.shape[1]} "
                         f"N={dy.shape[1]}")


def _launch_dw(x, dy, group_sizes, block_m, out_dtype):
    global dw_tc_launches
    tc = dw_route(x.dtype) == "tensor_cores"
    code, gs = _kernel_args(x, {"dy": dy}, group_sizes, block_m, "gmm_dw")
    if tc:
        _tc_dw_args(x, dy, block_m)
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the tensor-core gmm_dw kernel writes "
                             f"float32 or bfloat16, got {out_dtype}")
    m, k_dim = x.shape
    n_dim = dy.shape[1]
    e = gs.shape[0]
    nu = _live_blocks(gs, block_m)
    # the CUDA-core route writes f32 only; the tensor-core route writes
    # out_dtype from its accumulators
    kernel_dtype = out_dtype if tc else torch.float32
    dw = torch.empty((e, k_dim, n_dim), dtype=kernel_dtype,
                     device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), dy.data_ptr(), gs.data_ptr(), nu.data_ptr(),
                dw.data_ptr(), m, k_dim, n_dim, e, block_m, code)
        if tc:
            out_code = _build.DTYPE_CODES[
                str(kernel_dtype).removeprefix("torch.")]
            rc = lib.gmm_dw_tc(*args, out_code, stream)
        else:
            rc = lib.gmm_dw(*args, stream)
    _build.check(rc, "gmm_dw_tc" if tc else "gmm_dw")
    launches["gmm_dw"] += 1
    dw_tc_launches += tc
    return dw.to(out_dtype)


def gmm_dw(x, dy, group_sizes, block_m: int = 128,
           out_dtype=torch.float32):
    """``dw`` [E, K, N] of :func:`gmm_dw_reference`, f32 sums rounded
    once to ``out_dtype`` (float32 by default): K6 on CUDA tensors by
    the route :func:`dw_route` picks (dy is cast to x's dtype first),
    the plain version on CPU tensors.  The kernel writes every entry,
    zeros included.  The tensor-core route writes float32 or bfloat16
    from its accumulators; the CUDA-core route writes float32, cast
    after."""
    _check_dw(x, dy, group_sizes, block_m)
    if not on_card(x, "gmm_dw"):
        return gmm_dw_reference(x, dy, group_sizes, block_m).to(out_dtype)
    return _launch_dw(x, dy.to(x.dtype).contiguous(), group_sizes, block_m,
                      out_dtype)


# --------------------------------------------------------------------------
# Differentiable entry point
# --------------------------------------------------------------------------

class _Gmm(torch.autograd.Function):
    """The custom VJP of the JAX ``gmm``: dx = gmm(dy, w^T) through K5's
    transposed read, cast to x's dtype; dw through K6, its f32 sums
    rounded once to w's dtype (the JAX ``_gmm_bwd``'s cast);
    ``group_sizes`` is data and gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, block_m):
        out = gmm_forward(x, w, group_sizes, block_m)
        ctx.save_for_backward(x, w, group_sizes)
        ctx.block_m = block_m
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm_forward(dy, w, group_sizes, ctx.block_m,
                             transpose_w=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gmm_dw(x, dy, group_sizes, ctx.block_m,
                        out_dtype=w.dtype)
        return dx, dw, None, None


def gmm(x, w, group_sizes, block_m: int = 128):
    """Grouped matmul: rows of ``x`` [M, K] are grouped by expert
    (group ``e`` spans ``group_sizes[:e].sum()`` onward, every group a
    multiple of ``block_m`` rows), each multiplied by ``w[e]`` [E, K, N]
    -> [M, N] in x's dtype.  Differentiable in x and w."""
    return _Gmm.apply(x, w, group_sizes, block_m)


__all__ = ["TC_BLOCK_M", "TC_DW_TILE", "TILE_M", "dw_route",
           "dw_tc_launches", "gmm", "gmm_dw", "gmm_dw_reference",
           "gmm_forward", "gmm_reference", "gmm_route", "launches",
           "pick_gmm_blocks", "tc_launches"]
