"""Flash attention: hand-written CUDA kernels and their plain versions.

The counterpart of ``elephas_tpu/ops/pallas_attention.py``. The CUDA
kernel in ``csrc/flash_fwd.cu`` replaces the TPU kernel ``_fwd_kernel``;
the two in ``csrc/flash_bwd.cu`` replace ``_dq_kernel`` and
``_dkv_kernel`` (see the notes at the top of those files for their
designs and what bounds them on the H100). :func:`flash_forward` mirrors
``flash_hop_forward`` and returns ``(o, lse)``; :func:`flash_backward`
mirrors ``flash_hop_backward``: given the global ``lse`` and ``delta =
rowsum(dO * O)`` it returns ``(dq, dk, dv)``, launching the dQ kernel
(:func:`flash_dq`) and the dK/dV kernel (:func:`flash_dkv`).
At head dims 136-256 in bf16, and 40-256 in f32, the dK/dV kernel's k
tiles are cut into chunks of about equal work (:func:`dkv_plan`: a pure
function of the shapes, offsets, mask and the card's SM count), one CTA
each, so a multi-query group's walk over its query heads spreads over
the SMs; a split k tile's chunks write f32 partials, which a second
kernel sums in chunk order (:func:`flash_dkv_reduce`).
:func:`flash_attention` mirrors the single-device, differentiable
``flash_attention``: a ``torch.autograd.Function`` over the forward and
the two backward kernels, as the ``_flash`` custom VJP is.

On CPU tensors each wrapper computes its plain version; on CUDA tensors
it launches its kernel or raises: a head dim the kernels do not take
(:func:`kernel_takes_head_dim`: a multiple of 8 from 8 to 256) raises,
there is no plain fallback. The kernels have bodies 16, 32, 64, 128 and
256 columns wide; a head dim d runs the narrowest body at least d wide, its
tensor maps holding d, so TMA reads each row's d values and fills the
tile's other columns with zeros in shared memory, and the kernels store
only each row's first d columns. In f32 the backward runs on the tensor
cores as 3xTF32 products (``csrc/flash_bwd_f32.cu``): at head dims 8-32
dQ, dK/dV and the forward run strip bodies (:func:`f32_narrow_body`: a
warp a strip of 16 rows, 16-byte cp.async; ``csrc/f32_narrow.cuh``), at
40-256 dQ and dK/dV run CTAs of strips sharing a ring of tiles
(:func:`f32_wide_body`); f32 launches are counted, and each body's
apart (``flash_forward.f32_launches``, ``.f32_narrow_launches``,
``flash_backward.dq_f32_launches``, ``.dq_f32_narrow_launches``,
``.dq_f32_wide_launches``, and the same for dK/dV). The wrappers
pad nothing in device memory; operands that are not 16-byte aligned are
copied. Shapes follow the JAX package: q and dO ``(B, H, Sq, D)``, k/v
``(B, KVH, Sk, D)`` with ``KVH`` dividing ``H`` (GQA), lse and delta
``(B, H, Sq)`` f32, bf16 or f32 otherwise.
"""
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _kernels
from .attention import NEG_INF

__all__ = ["flash_attention", "flash_forward", "flash_forward_plain",
           "flash_backward", "flash_backward_plain", "flash_dq",
           "flash_dq_plain", "flash_dkv", "flash_dkv_plain",
           "flash_dkv_chunked_plain", "flash_dkv_partials",
           "flash_dkv_reduce",
           "flash_dkv_reduce_plain", "dkv_plan", "dkv_live_q_tiles",
           "dkv_step", "DkvPlan", "DKV_ROWS", "kernel_takes_head_dim",
           "f32_narrow_body", "f32_wide_body", "body_width", "BLOCK"]


def kernel_takes_head_dim(d: int) -> bool:
    """Whether the CUDA kernels take head dim ``d``, bf16 and f32: a
    multiple of 8 (a row of d bf16 values is then a multiple of the
    tensor maps' 16-byte stride unit) from 8 to 256, the widest body
    (``takes_head_dim`` in ``csrc/hopper.cuh``). That covers the repo's
    configurations (16, 32, 64), most published LMs (128: Llama-2-7B,
    Mistral-7B), Gemma-2B and -7B and GPT-J (256), Phi-3-mini (96),
    Phi-2 (80), DiT-XL/2 (72). The CPU plain versions take any."""
    return d % 8 == 0 and 8 <= d <= 256


def body_width(d: int) -> int:
    """The width of the body a head dim ``d`` runs on: the narrowest of
    16, 32, 64, 128 and 256 at least ``d`` (``with_head_dim`` in
    ``csrc/hopper.cuh``)."""
    return next(w for w in (16, 32, 64, 128, 256) if w >= d)


def f32_narrow_body(dtype: torch.dtype, d: int) -> bool:
    """Whether a CUDA call at head dim ``d`` runs the f32 strip bodies of
    the forward, dQ and dK/dV (``csrc/f32_narrow.cuh``: a warp a strip of
    16 rows, 3xTF32 products on the tensor cores): f32 at the bodies of
    widths 16 and 32, head dims 8-32. Wider f32 head dims run
    :func:`f32_wide_body` in the backward and the 256-thread CUDA-core
    body in the forward."""
    return dtype == torch.float32 and d <= 32


def f32_wide_body(dtype: torch.dtype, d: int) -> bool:
    """Whether a CUDA call at head dim ``d`` runs the f32 backward's
    tensor-core bodies of widths 64-256 (``csrc/flash_bwd_f32.cu``: CTAs
    of 16-row strips sharing a ring of tiles, a warp 64 columns of a
    strip, 3xTF32 products; dK/dV on a :func:`dkv_plan`): f32 at head
    dims 40-256. The forward there runs the CUDA-core body."""
    return dtype == torch.float32 and 32 < d <= 256


#: the one block size :func:`flash_attention` takes by name; the kernels
#: pick their own tiles (32, 64 or 128 rows, csrc/flash_*.cu)
BLOCK = 64


def _valid_mask(sq: int, sk: int, q_offset: int, k_offset: int,
                causal: bool, window: Optional[int],
                device) -> torch.Tensor:
    """(Sq, Sk) validity on GLOBAL positions, as the TPU kernel masks."""
    qg = q_offset + torch.arange(sq, device=device)[:, None]
    kg = k_offset + torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (kg <= qg)
    if window is not None:
        valid = valid & (kg > qg - window)
    return valid


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: int = 0, k_offset: int = 0,
                        causal: bool = True, window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in f32: one full-row
    masked softmax instead of the online recurrence. Fully masked rows
    give O = 0 and LSE = -1e30 + log(1e-30), as the kernel does."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    groups = h // kvh
    qf = q.float()
    kf = k.float().repeat_interleave(groups, dim=1)
    vf = v.float().repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / math.sqrt(d))
    valid = _valid_mask(sq, sk, int(q_offset), int(k_offset), causal,
                        window, q.device)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, Sq, D) and k/v (B, KVH, Sk, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"kv heads {k.shape[1]} must divide query heads "
                         f"{q.shape[1]} (GQA)")


def _kernel_operands(q: torch.Tensor, **tensors: torch.Tensor):
    """Check the operands of a CUDA flash kernel (a head dim the kernels
    take; ``q`` and the named tensors of q's dtype, on q's device,
    contiguous) and return them in order, cloned where they are not
    16-byte aligned."""
    if not kernel_takes_head_dim(q.shape[3]):
        raise ValueError(
            f"no flash kernel for head_dim {q.shape[3]}: the kernels take "
            f"a head_dim that is a multiple of 8 from 8 to 256")
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), *tensors.items()):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # TMA, the bf16 kernels' vector loads and the f32 strip bodies'
    # 16-byte cp.async need 16-byte aligned operands
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (q, *tensors.values()))


def _check_window(window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int = 0, k_offset: int = 0, causal: bool = True,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block attention of q against one k/v shard, masked on global
    positions (``q_offset``/``k_offset`` place the shards); returns
    ``(o, lse)`` with ``o`` in q's dtype and ``lse`` ``(B, H, Sq)`` f32.
    Counts each kernel launch in ``flash_forward.launches``, the f32 ones
    also in ``flash_forward.f32_launches`` and those of them that ran the
    strip body (:func:`f32_narrow_body`) in
    ``flash_forward.f32_narrow_launches``."""
    _check(q, k, v)
    _check_window(window)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, q_offset, k_offset, causal,
                                   window)
    q, k, v = _kernel_operands(q, k=k, v=v)
    b, h, sq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _fwd_launch(q, k, v, o, lse, q_offset, k_offset, causal, window)
    flash_forward.launches += 1
    if q.dtype == torch.float32:
        flash_forward.f32_launches += 1
        if f32_narrow_body(q.dtype, q.shape[3]):
            flash_forward.f32_narrow_launches += 1
    return o, lse


def _fwd_launch(q, k, v, o, lse, q_offset, k_offset, causal,
                window) -> None:
    """The forward kernel on checked operands, into ``o`` (q's shape)
    and ``lse``; it writes each row's head_dim values and nothing
    past them."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    err = _kernels.library().etpu_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, kvh, sq, sk, d, int(q_offset), int(k_offset),
        int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, "flash forward")


flash_forward.launches = 0
flash_forward.f32_launches = 0
flash_forward.f32_narrow_launches = 0


# ----------------------------------------------------------------- backward
def _bwd_probs(q, k, v, g, lse, delta, q_offset, k_offset, causal, window):
    """What both backward kernels recompute, in f32 with k/v expanded to
    the query heads: ``(p, ds, qf, gf, kf)`` with ``p = exp(s - lse)``
    and ``ds = p * (dp - delta) * scale`` (B, H, Sq, Sk), zero wherever
    the (q, k) pair is masked on global positions."""
    d = q.shape[3]
    groups = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, gf = q.float(), g.float()
    kf = k.float().repeat_interleave(groups, dim=1)
    vf = v.float().repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    valid = _valid_mask(q.shape[2], k.shape[2], int(q_offset),
                        int(k_offset), causal, window, q.device)
    # a fully masked row's lse is ~-1e30: exp overflows there, and the
    # mask drops it
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, qf, gf, kf


def flash_dq_plain(q, k, v, g, lse, delta, q_offset: int = 0,
                   k_offset: int = 0, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """The dQ kernel's function in plain PyTorch, in f32: ``dq = ds k``
    over full rows; returned in q's dtype."""
    _, ds, _, _, kf = _bwd_probs(q, k, v, g, lse, delta, q_offset,
                                 k_offset, causal, window)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)


def flash_dkv_plain(q, k, v, g, lse, delta, q_offset: int = 0,
                    k_offset: int = 0, causal: bool = True,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function in plain PyTorch, in f32: ``dk = ds^T
    q`` and ``dv = p^T dO``, each query head of a GQA group adding into
    its kv head; returned in k's and v's dtypes."""
    p, ds, qf, gf, _ = _bwd_probs(q, k, v, g, lse, delta, q_offset,
                                  k_offset, causal, window)
    b, kvh, sk, d = k.shape
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dk = dk.reshape(b, kvh, -1, sk, d).sum(2)
    dv = dv.reshape(b, kvh, -1, sk, d).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, g, lse, delta, q_offset: int = 0,
                         k_offset: int = 0, causal: bool = True,
                         window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Both backward kernels' function in plain PyTorch, in f32:
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    args = (q, k, v, g, lse, delta, q_offset, k_offset, causal, window)
    return (flash_dq_plain(*args), *flash_dkv_plain(*args))


def _check_bwd(q, k, v, g, lse, delta, window) -> None:
    _check(q, k, v)
    _check_window(window)
    if g.shape != q.shape:
        raise ValueError(f"the output gradient {tuple(g.shape)} must have "
                         f"q's shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {tuple(q.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on q's device")


def _bwd_launch(entry: str, q, k, v, g, lse, delta, outs, q_offset,
                k_offset, causal, window, extra=None) -> None:
    """One backward entry on checked operands. The dK/dV entry also takes
    ``extra`` after its outputs, the plan's table, chunk count and
    partials (:func:`flash_dkv_partials`); without one its 256-wide body
    runs one CTA a k tile, whole."""
    if extra is None:
        extra = (None, 0, None) if entry == "etpu_flash_bwd_dkv" else ()
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    lib = _kernels.library()
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        *extra, b, h, kvh, sq, sk, d, int(q_offset), int(k_offset),
        int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, entry)


def flash_dq(q, k, v, g, lse, delta, q_offset: int = 0, k_offset: int = 0,
             causal: bool = True, window: Optional[int] = None
             ) -> torch.Tensor:
    """dQ of one (q, k/v shard) pair given the global ``lse`` and
    ``delta``: the dQ kernel on CUDA tensors (counted in
    ``flash_backward.dq_launches``, and in f32 also in
    ``.dq_f32_launches`` and, by body, ``.dq_f32_narrow_launches`` or
    ``.dq_f32_wide_launches``),
    :func:`flash_dq_plain` on CPU tensors."""
    _check_bwd(q, k, v, g, lse, delta, window)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, g, lse, delta, q_offset, k_offset,
                              causal, window)
    q, k, v, g = _kernel_operands(q, k=k, v=v, g=g)
    dq = torch.empty_like(q)
    _bwd_launch("etpu_flash_bwd_dq", q, k, v, g, lse, delta, (dq,),
                q_offset, k_offset, causal, window)
    flash_backward.dq_launches += 1
    if q.dtype == torch.float32:
        flash_backward.dq_f32_launches += 1
        if f32_narrow_body(q.dtype, q.shape[3]):
            flash_backward.dq_f32_narrow_launches += 1
        elif f32_wide_body(q.dtype, q.shape[3]):
            flash_backward.dq_f32_wide_launches += 1
    return dq


def flash_dkv(q, k, v, g, lse, delta, q_offset: int = 0, k_offset: int = 0,
              causal: bool = True, window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of one (q, k/v shard) pair given the global ``lse`` and
    ``delta``, at the narrow kv width: the dK/dV kernel on CUDA tensors
    (counted in ``flash_backward.dkv_launches``), followed at the bodies
    that run a plan (the 256-wide bf16 one, the f32 ones at 40-256) by
    the reduction of its split k tiles where the plan splits one
    (:func:`flash_dkv_reduce`); :func:`flash_dkv_plain` on CPU
    tensors."""
    _check_bwd(q, k, v, g, lse, delta, window)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, g, lse, delta, q_offset, k_offset,
                               causal, window)
    dk, dv, partials, plan = flash_dkv_partials(
        q, k, v, g, lse, delta, q_offset, k_offset, causal, window)
    if partials is not None:
        flash_dkv_reduce(partials, plan, dk, dv)
    return dk, dv


def flash_dkv_partials(q, k, v, g, lse, delta, q_offset: int = 0,
                       k_offset: int = 0, causal: bool = True,
                       window: Optional[int] = None):
    """The dK/dV kernel alone on CUDA tensors (counted in
    ``flash_backward.dkv_launches``, and in f32 also in
    ``.dkv_f32_launches`` and, by body, ``.dkv_f32_narrow_launches`` or
    ``.dkv_f32_wide_launches``):
    ``(dk, dv, partials, plan)``. At the bodies that run a plan (the
    256-wide bf16 one, :func:`f32_wide_body`) ``plan`` is the call's
    :func:`dkv_plan`, and where it splits a k tile that tile's rows of dk
    and dv are left for :func:`flash_dkv_reduce` and ``partials``
    (``(plan.slots, 2, plan.rows, body width)`` f32) holds its chunks'
    sums; elsewhere ``partials`` is None (and ``plan`` too at the bodies
    without one)."""
    _check_bwd(q, k, v, g, lse, delta, window)
    q, k, v, g = _kernel_operands(q, k=k, v=v, g=g)
    d = q.shape[3]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan = _dkv_plan_for(q, k, q_offset, k_offset, causal, window)
    wide32 = f32_wide_body(q.dtype, d)
    extra, partials = (None, 0, None), None
    if plan is not None and (plan.slots or wide32):
        # the bf16 body gets the table only where it splits a k tile (else
        # one CTA a k tile, whole, as the grid gives it); the f32 body
        # always runs one CTA a chunk
        if plan.slots:
            partials = torch.empty((plan.slots, 2, plan.rows, body_width(d)),
                                   dtype=torch.float32, device=q.device)
        extra = (_plan_table(plan, q.device).data_ptr(), len(plan.chunks),
                 None if partials is None else partials.data_ptr())
    _bwd_launch("etpu_flash_bwd_dkv", q, k, v, g, lse, delta, (dk, dv),
                q_offset, k_offset, causal, window, extra)
    flash_backward.dkv_launches += 1
    if q.dtype == torch.float32:
        flash_backward.dkv_f32_launches += 1
        if f32_narrow_body(q.dtype, d):
            flash_backward.dkv_f32_narrow_launches += 1
        elif wide32:
            flash_backward.dkv_f32_wide_launches += 1
    return dk, dv, partials, plan


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   q_offset: int = 0, k_offset: int = 0, causal: bool = True,
                   window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-hop backward with GLOBAL row statistics, as the JAX
    ``flash_hop_backward``: the softmax over the whole ring factorizes
    as ``exp(s - lse_global)``, so dq/dk/dv of this shard pair are exact
    given the global ``lse`` and ``delta = rowsum(dO * O_global)``.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes, dk/dv at the narrow
    kv width. On CUDA tensors it launches the dQ and the dK/dV kernels
    (``g`` must be contiguous: it raises otherwise) and counts them in
    ``flash_backward.dq_launches`` / ``.dkv_launches``."""
    args = (q, k, v, g, lse, delta, q_offset, k_offset, causal, window)
    return (flash_dq(*args), *flash_dkv(*args))


flash_backward.dq_launches = 0
flash_backward.dkv_launches = 0
flash_backward.dkv_reduce_launches = 0
flash_backward.dq_f32_launches = 0
flash_backward.dq_f32_narrow_launches = 0
flash_backward.dq_f32_wide_launches = 0
flash_backward.dkv_f32_launches = 0
flash_backward.dkv_f32_narrow_launches = 0
flash_backward.dkv_f32_wide_launches = 0


# ------------------------------------------------ dK/dV on a work plan
#: key rows of a k tile, and query rows of a step, of the 256-wide bf16
#: dK/dV body (csrc/flash_bwd.cu ``dkv::Layout<256>``)
DKV_ROWS = 64
#: the f32 tensor-core dK/dV body by width (csrc/flash_bwd_f32.cu
#: ``Wide<W>``): its k tile's rows (``RES``), a step's q rows (``TILE``)
#: and its resident CTAs an SM (shared memory: 105 KB at 64, 215 KB at
#: 128, 211 KB at 256)
_F32_WIDE = {64: (64, 64, 2), 128: (64, 64, 1), 256: (32, 32, 1)}
#: the fewest steps a chunk of a split k tile takes: shorter chunks would
#: spend more on loading K and V and on the reduction than they spread
DKV_MIN_STEPS = 4


class DkvPlan(NamedTuple):
    """A dK/dV body's work plan (:func:`dkv_plan`).

    ``chunks``: one ``(k tile, kv row, first step, steps, slot)`` a CTA,
    the heaviest first; a k tile's steps are its walk over (query head of
    the group, live q tile), head-major (:func:`dkv_step`); ``slot`` is
    the chunk's partial slot, or -1 where the chunk is its k tile's only
    one. ``reduce``: one ``(k tile, kv row, first slot, slots)`` a split
    k tile, its chunks' slots consecutive in walk order. ``slots``: the
    partial slots in all. ``rows`` and ``q_rows``: the rows of a k tile
    and of a q tile."""
    chunks: Tuple[Tuple[int, int, int, int, int], ...]
    reduce: Tuple[Tuple[int, int, int, int], ...]
    slots: int
    rows: int = DKV_ROWS
    q_rows: int = DKV_ROWS


def _rows_meet(q_lo, q_hi, k_lo, k_hi, q_offset, k_offset, causal,
               window) -> bool:
    """csrc/common.cuh ``rows_meet``: whether some (q, k) pair of the
    rows is unmasked on global positions."""
    live = not causal or k_offset + k_lo <= q_offset + q_hi
    if window:
        live = live and k_offset + k_hi > q_offset + q_lo - window
    return live


def dkv_live_q_tiles(kt: int, sq: int, sk: int, q_offset: int = 0,
                     k_offset: int = 0, causal: bool = True,
                     window: Optional[int] = None, rows: int = DKV_ROWS,
                     q_rows: int = DKV_ROWS) -> range:
    """The q tiles (``q_rows`` rows each) that k tile ``kt`` (of ``rows``
    rows) meets: one run, as the kernels' ``live_q_tiles`` find it (the
    causal rule drops tiles from the start, the window's from the
    end)."""
    k0 = kt * rows
    k_hi = min(k0 + rows, sk) - 1
    live = [qi for qi in range(-(-sq // q_rows))
            if _rows_meet(qi * q_rows, min((qi + 1) * q_rows, sq) - 1,
                          k0, k_hi, q_offset, k_offset, causal, window)]
    return range(live[0], live[-1] + 1) if live else range(0)


def dkv_step(t: int, live: range) -> Tuple[int, int]:
    """Step ``t`` of a k tile's walk: (query head of the group, q tile),
    as the kernel maps it."""
    g, i = divmod(t, len(live))
    return g, live.start + i


@functools.lru_cache(maxsize=256)
def dkv_plan(b: int, h: int, kvh: int, sq: int, sk: int, q_offset: int = 0,
             k_offset: int = 0, causal: bool = True,
             window: Optional[int] = None, sms: int = 132,
             rows: int = DKV_ROWS, q_rows: int = DKV_ROWS) -> DkvPlan:
    """The chunks of a dK/dV body whose k tiles hold ``rows`` key rows
    and whose steps ``q_rows`` query rows (the 256-wide bf16 body's 64
    and 64 by default) for these shapes on a card of ``sms`` SMs (times
    the body's CTAs an SM). A k tile's steps (its group's ``h // kvh``
    query heads times its live q tiles) are cut into chunks of about
    equal length, as many as a step target of the whole launch's steps
    over the SMs (at least :data:`DKV_MIN_STEPS`) asks: a k tile of fewer
    steps than the target stays one chunk, as every k tile does where the
    k tiles alone fill the card. Every k tile gets a chunk, a dead one
    too (its dK and dV are zeros). At ``lm_d256``'s fit (B 2, H 8 over
    KVH 1, S 1024, causal) 2176 steps on 132 SMs make a target of 17: 8,
    8, 7, 7, ..., 1, 1 chunks for k tiles 0..15, 144 CTAs."""
    window = int(window) if window else None
    grp = h // kvh
    tiles = [(kt, dkv_live_q_tiles(kt, sq, sk, q_offset, k_offset, causal,
                                   window, rows, q_rows))
             for kt in range(-(-sk // rows))]
    total = b * kvh * grp * sum(len(live) for _, live in tiles)
    target = max(DKV_MIN_STEPS, -(-total // max(sms, 1)))
    chunks, reduce, slots = [], [], 0
    for row in range(b * kvh):
        for kt, live in tiles:
            steps = grp * len(live)
            n = max(1, -(-steps // target))
            if n > 1:
                reduce.append((kt, row, slots, n))
            first = 0
            for c in range(n):
                count = steps // n + (c < steps % n)
                chunks.append((kt, row, first, count,
                               slots + c if n > 1 else -1))
                first += count
            if n > 1:
                slots += n
    # heaviest first; among equals the first k tiles, as the unsplit
    # grid ran them
    chunks.sort(key=lambda c: (-c[3], c[0], c[1]))
    return DkvPlan(tuple(chunks), tuple(reduce), slots, rows, q_rows)


@functools.lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dkv_plan_for(q, k, q_offset, k_offset, causal, window):
    """The plan of a CUDA dK/dV call that runs the 256-wide bf16 body or
    an f32 tensor-core body at 40-256 (:func:`f32_wide_body`), else
    None."""
    b, h, sq, d = q.shape
    if q.dtype == torch.bfloat16 and d > 128:
        rows, q_rows, ctas = DKV_ROWS, DKV_ROWS, 1
    elif f32_wide_body(q.dtype, d):
        rows, q_rows, ctas = _F32_WIDE[body_width(d)]
    else:
        return None
    return dkv_plan(b, h, k.shape[1], sq, k.shape[2], int(q_offset),
                    int(k_offset), bool(causal), window,
                    _multiprocessors(q.device) * ctas, rows, q_rows)


@functools.lru_cache(maxsize=256)
def _plan_table(plan: DkvPlan, device: torch.device) -> torch.Tensor:
    """The plan as the kernels read it: int32 rows of 5 on the device,
    the chunks' and then the reduction's (padded with a 0); kept per plan
    and device, so a training loop copies it once."""
    rows = [*plan.chunks, *(r + (0,) for r in plan.reduce)]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 5).to(device)


def flash_dkv_reduce_plain(partials: torch.Tensor, plan: DkvPlan,
                           dk: torch.Tensor, dv: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduction kernel's function in plain PyTorch: each split k
    tile's f32 partials (``partials`` ``(slots, 2, plan.rows, W)``, dK
    then dV, W >= head_dim) summed in chunk order, cast once to dk's
    dtype and written into that tile's rows of ``dk`` and ``dv`` (``(B,
    KVH, Sk, head_dim)``, in place); returns them."""
    sk, d = dk.shape[2], dk.shape[3]
    rows_k, rows_v = dk.view(-1, sk, d), dv.view(-1, sk, d)
    for kt, row, slot0, n in plan.reduce:
        k0 = kt * plan.rows
        rows = min(plan.rows, sk - k0)
        acc = partials[slot0].clone()
        for slot in range(slot0 + 1, slot0 + n):
            acc += partials[slot]
        rows_k[row, k0:k0 + rows] = acc[0, :rows, :d].to(dk.dtype)
        rows_v[row, k0:k0 + rows] = acc[1, :rows, :d].to(dv.dtype)
    return dk, dv


def flash_dkv_reduce(partials: torch.Tensor, plan: DkvPlan,
                     dk: torch.Tensor, dv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduction of a dK/dV plan's split k tiles into ``dk`` and
    ``dv`` (in place; the unsplit tiles' rows untouched): the kernel on
    CUDA tensors (counted in ``flash_backward.dkv_reduce_launches``),
    :func:`flash_dkv_reduce_plain` on CPU tensors. The kernel takes bf16
    outputs at head dims 136-256 or f32 ones at 40-256, and partials
    ``(plan.slots, 2, plan.rows, W)`` f32, W the body's width
    (:func:`body_width`)."""
    if partials.shape[0] != plan.slots or partials.dtype != torch.float32:
        raise ValueError(f"expected {plan.slots} f32 partial slots, got "
                         f"{partials.dtype} {tuple(partials.shape)}")
    if dk.device.type == "cpu":
        return flash_dkv_reduce_plain(partials, plan, dk, dv)
    if not plan.reduce:
        return dk, dv
    sk, d = dk.shape[2], dk.shape[3]
    bf16 = dk.dtype == torch.bfloat16
    if ((d <= 128 if bf16 else not f32_wide_body(dk.dtype, d)) or d % 8
            or dv.dtype != dk.dtype or dv.shape != dk.shape
            or partials.shape[1:] != (2, plan.rows, body_width(d))
            or not all(t.is_contiguous() and t.device == dk.device
                       for t in (dk, dv, partials))):
        raise ValueError("the dK/dV reduction kernel takes bf16 dk/dv at "
                         "head dims 136-256 or f32 ones at 40-256, and "
                         "contiguous (slots, 2, plan.rows, body width) f32 "
                         "partials on their device")
    table = _plan_table(plan, dk.device)
    err = _kernels.library().etpu_flash_dkv_reduce(
        partials.data_ptr(), table[len(plan.chunks):].data_ptr(),
        len(plan.reduce), dk.data_ptr(), dv.data_ptr(), sk, d, plan.rows,
        int(bf16), torch.cuda.current_stream(dk.device).cuda_stream)
    _kernels.check(err, "flash dK/dV reduction")
    flash_backward.dkv_reduce_launches += 1
    return dk, dv


def flash_dkv_chunked_plain(q, k, v, g, lse, delta, q_offset: int = 0,
                            k_offset: int = 0, causal: bool = True,
                            window: Optional[int] = None,
                            plan: Optional[DkvPlan] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A dK/dV plan's split path in plain PyTorch, in f32: for each chunk
    of ``plan`` (default: the 256-wide bf16 body's :func:`dkv_plan` on
    132 SMs) its steps' ``ds^T q`` and ``p^T dO`` summed into an f32
    partial of its k tile (or written whole where the chunk is the tile's
    only one), then :func:`flash_dkv_reduce_plain`. Returns dk, dv in k's
    and v's dtypes."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if plan is None:
        plan = dkv_plan(b, h, kvh, sq, sk, int(q_offset), int(k_offset),
                        bool(causal), window)
    p, ds, qf, gf, _ = _bwd_probs(q, k, v, g, lse, delta, q_offset,
                                  k_offset, causal, window)
    grp = h // kvh
    dk = torch.zeros((b, kvh, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    rows, q_rows = plan.rows, plan.q_rows
    partials = torch.zeros((plan.slots, 2, rows, d),
                           dtype=torch.float32, device=q.device)
    for kt, row, first, count, slot in plan.chunks:
        bi, kh = divmod(row, kvh)
        k0, k1 = kt * rows, min((kt + 1) * rows, sk)
        live = dkv_live_q_tiles(kt, sq, sk, int(q_offset), int(k_offset),
                                causal, window, rows, q_rows)
        acc = torch.zeros((2, k1 - k0, d), dtype=torch.float32,
                          device=q.device)
        for t in range(first, first + count):
            gi, qi = dkv_step(t, live)
            hq = kh * grp + gi
            q0, q1 = qi * q_rows, min((qi + 1) * q_rows, sq)
            acc[0] += ds[bi, hq, q0:q1, k0:k1].T @ qf[bi, hq, q0:q1]
            acc[1] += p[bi, hq, q0:q1, k0:k1].T @ gf[bi, hq, q0:q1]
        if slot < 0:
            dk[bi, kh, k0:k1], dv[bi, kh, k0:k1] = acc[0], acc[1]
        else:
            partials[slot, :, :k1 - k0] = acc
    flash_dkv_reduce_plain(partials, plan, dk, dv)
    return dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The ``_flash`` custom VJP: the forward kernel, saving the JAX
    residuals ``(q, k, v, o, lse)``; the backward computes ``delta``
    outside the kernels (as ``_bwd`` does) and launches both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_forward(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        delta = torch.sum(g.float() * o.float(), dim=-1)
        dq, dk, dv = flash_backward(q, k, v, g.contiguous(), lse, delta,
                                    causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention over ``(batch, heads, seq, head_dim)`` tensors
    (k/v may carry fewer heads: GQA). Differentiable: the backward runs
    the dQ and dK/dV kernels (their plain versions on the CPU). The
    kernels pick their own tiles: ``block_q``/``block_k`` may only be
    :data:`BLOCK`, and sequence lengths need not be multiples of any
    tile."""
    if q.ndim != 4:
        raise ValueError(f"expected (batch, heads, seq, head_dim), got "
                         f"{tuple(q.shape)}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk is not None and blk != BLOCK:
            raise NotImplementedError(
                f"{name}={blk}: the CUDA kernels pick their own tiles; "
                f"only {BLOCK} is accepted")
    _check_window(window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    window = None if window is None else int(window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    # no graph to record (inference): the forward kernel alone, without
    # the autograd Function's host cost
    o, _ = flash_forward(q, k, v, causal=causal, window=window)
    return o
