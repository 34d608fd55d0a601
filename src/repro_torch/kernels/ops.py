"""Public entry points of the port's kernels: plans call these only.

Counterpart of ``repro.kernels.ops``.  Dispatch is by device: a CUDA tensor
goes to the hand-written CUDA kernel (which launches or raises — nothing
falls back), a CPU tensor to the plain PyTorch version in ``ref.py``.
``use_kernels(False)`` or ``REPRO_NO_KERNELS=1`` is an explicit choice of
the plain version on every device.

Each CUDA wrapper counts its launches (``launch_counts``), so a run can
show that its path really went through the kernels.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bitset_pack import predicate_bitset_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import (
    flash_attention_fwd_cuda,
    flash_attention_fwd_gpu,
    flash_attention_fwd_tc_cuda,
    group,
    ungroup,
)
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_gpu,
    flash_attention_bwd_tc_cuda,
)
from repro_torch.kernels.grouped_agg import filtered_group_sum_cuda
from repro_torch.kernels.mbit_codec import mbit_encode_cuda
from repro_torch.kernels.scan_filter import scan_filter_cuda
from repro_torch.kernels.topk_select import block_topk_cuda
from repro_torch.kernels.wire_codec import (
    ef_decode_cuda,
    ef_encode_cuda,
    mask_fold_cuda,
    mask_unfold_cuda,
)

_FORCE_REF = os.environ.get("REPRO_NO_KERNELS", "0") == "1"
_USE_KERNELS = not _FORCE_REF

_WRAPPERS = {"scan_filter": scan_filter_cuda,
             "filtered_group_sum": filtered_group_sum_cuda,
             "ef_encode": ef_encode_cuda,
             "ef_decode": ef_decode_cuda,
             "mask_fold": mask_fold_cuda,
             "mask_unfold": mask_unfold_cuda,
             "flash_attention_fwd": flash_attention_fwd_cuda,
             "flash_attention_fwd_tc": flash_attention_fwd_tc_cuda,
             "flash_attention_bwd": flash_attention_bwd_cuda,
             "flash_attention_bwd_tc": flash_attention_bwd_tc_cuda,
             "decode_attention": decode_attention_cuda,
             "block_topk": block_topk_cuda,
             "predicate_bitset": predicate_bitset_cuda,
             "mbit_encode": mbit_encode_cuda}


def use_kernels(enable: bool) -> None:
    global _USE_KERNELS
    _USE_KERNELS = enable and not _FORCE_REF


def _kernel_path(t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return _USE_KERNELS
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Zero every launch counter, the local-shard counts too."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
    for k in _LOCAL_SHARD:
        _LOCAL_SHARD[k] = 0


# the grouped attention's directions (:func:`flash_attention`) and the
# one-token attention (:func:`decode_attention`) run under a mesh on a
# rank's local block, counted whichever device runs them
_LOCAL_SHARD = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "decode_attention": 0}


def local_shard_counts() -> dict:
    """Function -> runs under a mesh on a rank's local (B*KV) block since
    the last reset: the grouped flash attention's forward (B7 on the
    card) and backward (B8), the one-token attention (B9)."""
    return dict(_LOCAL_SHARD)


def add_launch_counts(counts: dict, local: dict | None = None) -> None:
    """Add ``counts`` (name -> launches) to the counters, and ``local``
    (function -> runs) to :func:`local_shard_counts`: what a replayed CUDA
    graph runs without a Python call (``serve.engine``)."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n
    for name, n in (local or {}).items():
        _LOCAL_SHARD[name] += n


def filtered_group_sum(measures, groups, pred, *, cutoff, num_groups):
    """Per-node ``sum(measures[n])`` by group over rows with
    ``pred[n] <= cutoff``: (P, N, C), (P, N), (P, N) -> (P, G, C) f32."""
    if _kernel_path(measures):
        return filtered_group_sum_cuda(measures, groups, pred,
                                       cutoff=cutoff, num_groups=num_groups)
    return ref.filtered_group_sum(measures, groups, pred, cutoff, num_groups)


def scan_filter(words, lo, hi, *, rows, padded_rows, width, negate=False):
    """Validity bitset of ``lo <= code <= hi`` (optionally negated) over
    node-stacked packed words (P, wpn) -> (P, padded_rows / 32) int32;
    rows past ``rows`` are invalid.  The bounds are Python ints, or int32
    tensors on the words' device (read there, never on the host): 0-d,
    or ``(B,)`` for B lanes of bounds in one pass, which gives (B, P,
    padded_rows / 32)."""
    if _kernel_path(words):
        return scan_filter_cuda(words, lo, hi, rows=rows,
                                padded_rows=padded_rows, width=width,
                                negate=negate)
    return ref.scan_filter(words, lo, hi, rows, padded_rows, width, negate)


def ef_encode(buckets, bucket_mask, base, *, domain):
    """Packed request rows of sorted key buckets: (R, cap) int32 + bool,
    per-row key base (R,) int64 -> (R, packed_request_words) int32."""
    if _kernel_path(buckets):
        return ef_encode_cuda(buckets, bucket_mask, base, domain=domain)
    return ref.ef_encode(buckets, bucket_mask, base, domain)


def ef_decode(words, base, *, capacity, domain):
    """Inverse of :func:`ef_encode`: (R, W) int32 -> (keys (R, capacity)
    int32, mask (R, capacity) bool)."""
    if _kernel_path(words):
        return ef_decode_cuda(words, base, capacity=capacity, domain=domain)
    return ref.ef_decode(words, base, capacity, domain)


def mask_fold(mask):
    """(R, c) bool -> (R, ceil(c/32)) int32 bitset rows."""
    if _kernel_path(mask):
        return mask_fold_cuda(mask)
    return ref.mask_fold(mask)


def mask_unfold(words, *, n):
    """(R, w) int32 bitset rows -> (R, n) bool."""
    if _kernel_path(words):
        return mask_unfold_cuda(words, n)
    return ref.mask_unfold(words, n)


def block_topk(values, keys, *, k, mask=None, block=4096):
    """Per-block top-k of each row: (..., N) f32 values, int32 keys and an
    optional bool mask -> ((..., ceil(N / block), k) f32, int32 keys);
    ties to the lowest index, masked rows and pads -inf (pads with key
    INT32_MAX)."""
    if _kernel_path(values):
        return block_topk_cuda(values, keys, k=k, mask=mask, block=block)
    return ref.block_topk(values, keys, k, mask, block)


def predicate_bitset(column, *, value):
    """Packed bitset of ``column == value``: (..., N) int32 -> (...,
    ceil(N / 32)) int32 words, each row from bit 0."""
    if _kernel_path(column):
        return predicate_bitset_cuda(column, value=value)
    return ref.predicate_bitset(column, value)


def mbit_encode(q, *, m, group):
    """The §3.2.5 m-bit encoder per row: (..., K) int32 -> (words (...,
    ceil(K m / 32)) int32, shifts (..., K / group) int32)."""
    if _kernel_path(q):
        return mbit_encode_cuda(q, m=m, group=group)
    return ref.mbit_encode(q, m, group)


def mbit_decode_bounds(words, shifts, *, m, group):
    """Lower and upper bounds (..., G * group) int64 of :func:`mbit_encode`
    words: plain PyTorch on every device, as in the JAX package."""
    return ref.mbit_decode_bounds(words, shifts, m, group)


def flash_attention_fwd(qg, kg, vg, *, causal=True, window=None, prefix=0):
    """Grouped GQA attention forward: q (BKV, G, S, D), k and v
    (BKV, Sk, D) -> (out (BKV, G, S, D) in q's dtype, lse (BKV, G, S)
    f32)."""
    if _kernel_path(qg):
        return flash_attention_fwd_gpu(qg, kg, vg, causal=causal,
                                       window=window, prefix=prefix)
    return ref.flash_attention_fwd(qg, kg, vg, causal, window, prefix)


def flash_attention_bwd(qg, kg, vg, out, lse, do, *, causal=True,
                        window=None, prefix=0):
    """Gradients of :func:`flash_attention_fwd`: q, out and do
    (BKV, G, S, D), k and v (BKV, Sk, D), lse (BKV, G, S) f32 -> (dq, dk,
    dv) in the inputs' dtype; dk and dv summed over the G query heads."""
    if _kernel_path(qg):
        return flash_attention_bwd_gpu(qg, kg, vg, out, lse, do,
                                       causal=causal, window=window,
                                       prefix=prefix)
    return ref.flash_attention_bwd(qg, kg, vg, out, lse, do, causal, window,
                                   prefix)


class _FlashAttention(torch.autograd.Function):
    """Grouped attention with its flash backward, the counterpart of the
    JAX package's ``custom_vjp`` ``_flash_grouped``: the forward saves q,
    k, v, out and lse, the backward recomputes p tile by tile (B8 on the
    card).  Each direction dispatches by device."""

    @staticmethod
    def forward(ctx, qg, kg, vg, causal, window, prefix, local):
        out, lse = flash_attention_fwd(qg, kg, vg, causal=causal,
                                       window=window, prefix=prefix)
        ctx.save_for_backward(qg, kg, vg, out, lse)
        ctx.mask = (causal, window, prefix)
        ctx.local = local
        if local:
            _LOCAL_SHARD["flash_attention_fwd"] += 1
        return out

    @staticmethod
    def backward(ctx, do):
        causal, window, prefix = ctx.mask
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, do.contiguous(),
                                         causal=causal, window=window,
                                         prefix=prefix)
        if ctx.local:
            _LOCAL_SHARD["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None, None


def _flash(q, k, v, causal, window, prefix, local: bool):
    B, KV = q.shape[0], k.shape[2]
    qg, kg, vg = (t.contiguous() for t in group(q, k, v))
    out = _FlashAttention.apply(qg, kg, vg, causal, window, prefix, local)
    return ungroup(out, B, KV)


def _local_blocks(q, k, v, causal, window, prefix):
    """The grouped attention on this rank's block under the ambient mesh
    (the reference's ``shard_map`` over the fused (B*KV) dim, the batch
    axes outer and the kv-head axes inner).  Plain tensors are the rank's
    blocks already (the model code's local heads of its batch rows).
    DTensors must be laid out so: the batch sharded on the batch axes
    (dim 0), the heads on the kv-head axes (dim 2); any other layout
    raises, since the kernels never see a tensor gathered only to feed
    them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import runtime

    if not isinstance(q, DTensor):
        return _flash(q, k, v, causal, window, prefix, True)
    mesh = q.device_mesh
    batch, kv = runtime.axes_for("batch"), runtime.axes_for("kv_heads")
    want = tuple(Shard(0) if n in batch else Shard(2) if n in kv
                 else Replicate() for n in mesh.mesh_dim_names)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, DTensor) or any(
                mesh.size(j) > 1 and got != w
                for j, (got, w) in enumerate(zip(t.placements, want))):
            raise ValueError(
                f"flash attention under a mesh takes {name} sharded as "
                f"{want} (batch axes {batch}, kv-head axes {kv}), got "
                f"{getattr(t, 'placements', 'a plain tensor')}")
    out = _flash(q.to_local(), k.to_local(), v.to_local(), causal, window,
                 prefix, True)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def flash_attention(q, k, v, *, causal=True, window=None, prefix=0):
    """Differentiable flash attention in the (B, S, H, D) layout, GQA
    through the KV dim of k and v (B, Sk, KV, D): groups, runs
    :class:`_FlashAttention` (B7 forward, B8 backward), ungroups.
    Counterpart of ``repro.kernels.ops.flash_attention`` without block
    sizes (the kernels take any S).  Under an ambient mesh
    (``models.runtime``) it runs on each rank's local block, counted in
    :func:`local_shard_counts`."""
    from repro_torch.models import runtime

    if runtime.current() is not None:
        return _local_blocks(q, k, v, causal, window, prefix)
    return _flash(q, k, v, causal, window, prefix, False)


def _decode(q, k_cache, v_cache, length, k_scale, v_scale):
    if _kernel_path(q):
        return decode_attention_cuda(q, k_cache, v_cache, length,
                                     k_scale=k_scale, v_scale=v_scale)
    return ref.decode_attention(q, k_cache, v_cache, length, k_scale,
                                v_scale)


def _decode_local(q, k_cache, v_cache, length, k_scale, v_scale):
    """The one-token attention on this rank's (B*KV) rows under the
    ambient mesh (the reference's ``shard_map`` of B9 over the fused dim,
    ``runtime.fused_bkv_spec()``: the batch axes outer, the kv-head axes
    inner), counted in :func:`local_shard_counts`.  The tensors are the
    rank's rows already (the model code's local kv heads of its batch
    rows).  DTensors are refused: a DTensor nests its shards in mesh
    order, which is not that split in general, and the kernel never sees
    a tensor gathered only to feed it."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor)
           for t in (q, k_cache, v_cache, k_scale, v_scale)):
        raise ValueError("decode attention under a mesh takes this rank's "
                         "(B*KV) rows as plain tensors, not DTensors")
    _LOCAL_SHARD["decode_attention"] += 1
    return _decode(q, k_cache, v_cache, length, k_scale, v_scale)


def decode_attention(q, k_cache, v_cache, length, *, k_scale=None,
                     v_scale=None):
    """One-token attention: q (BKV, G, D) against caches (BKV, Smax, D),
    float or int8 with (BKV, Smax) f32 scales; positions >= ``length`` (a
    0-d int32 tensor on q's device) masked -> (BKV, G, D) in q's dtype.
    Under an ambient mesh (``models.runtime``) it runs on each rank's
    (B*KV) rows, counted in :func:`local_shard_counts`."""
    from repro_torch.models import runtime

    if runtime.current() is not None:
        return _decode_local(q, k_cache, v_cache, length, k_scale, v_scale)
    return _decode(q, k_cache, v_cache, length, k_scale, v_scale)
