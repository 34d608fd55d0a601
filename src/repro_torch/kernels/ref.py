"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro.kernels.ref`` for the kernels this port has.  They
repeat each kernel's arithmetic in straightforward tensor code, on the
node-stacked layout: the CPU path runs them, and ``chip_smoke.py`` holds
every CUDA kernel against them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import compression


def filtered_group_sum(measures, groups, pred, cutoff, num_groups):
    """One-hot contraction per node: (P, N, C), (P, N), (P, N) ->
    (P, G, C), in the measures' floating dtype (f32 for int inputs).
    Rows whose group lies outside [0, num_groups) match no one-hot row."""
    sel = pred <= cutoff
    ids = torch.arange(num_groups, dtype=groups.dtype, device=groups.device)
    onehot = (groups[:, None, :] == ids[None, :, None]) & sel[:, None, :]
    dtype = (measures.dtype if measures.is_floating_point()
             else torch.float32)
    return torch.matmul(onehot.to(dtype), measures.to(dtype))


def scan_filter(words, lo, hi, rows, padded_rows, width, negate=False):
    """Decode-then-compare version of the predicate-on-packed kernel:
    unpack the full column, apply the code-space range test, pack the
    validity bitset (rows past ``rows`` are never valid).
    words: (P, wpn) int32 -> (P, padded_rows / 32) int32.  ``lo`` and
    ``hi`` are ints or int32 tensors: 0-d, or ``(B,)`` for B lanes of
    bounds, which gives (B, P, padded_rows / 32)."""
    codes = compression.unpack_bits(words, padded_rows, width)
    if isinstance(lo, torch.Tensor) and lo.ndim == 1:
        lo, hi = lo[:, None, None], hi[:, None, None]
    elif not isinstance(lo, torch.Tensor):
        lo, hi = int(lo), int(hi)
    ok = (codes >= lo) & (codes <= hi)
    if negate:
        ok = ~ok
    ok &= torch.arange(padded_rows, device=words.device) < rows
    return compression.pack_bitset(ok)


# ---------------------------------------------------------------------------
# wire codec (§3.2.1): EF key buckets + folded validity mask
# ---------------------------------------------------------------------------


def mask_fold(mask):
    """(R, c) bool -> (R, ceil(c/32)) int32 bitset rows (bit j of word w is
    column 32 w + j)."""
    pad = (-mask.shape[1]) % 32
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    return compression.pack_bitset(mask)


def mask_unfold(words, n):
    """Inverse of :func:`mask_fold`: (R, w) int32 -> (R, n) bool."""
    return compression.unpack_bitset(words, n)


def ef_encode(buckets, bucket_mask, base, domain):
    """Scatter EF encoder: row r of ``buckets`` holds a sorted ascending
    prefix of keys under ``bucket_mask``, offsets taken from ``base[r]``
    and clipped into ``[0, domain)``.  One upper-bitvector bit per valid
    key at ``(off >> l) + j``, the low bits packed at width l, the mask
    bitset last: (R, ``compression.packed_request_words(cap, domain)``)
    int32."""
    rows, cap = buckets.shape
    l, uw, _ = compression.ef_params(cap, domain)
    offs = buckets.to(torch.int64) - base.to(torch.int64)[:, None]
    offs = torch.where(bucket_mask, offs, 0).clamp(0, domain - 1)
    j = torch.arange(cap, device=buckets.device)
    pos = (offs >> l) + j
    word = torch.where(bucket_mask, pos >> 5, uw)   # masked -> spill column
    bit = torch.where(bucket_mask, 1 << (pos & 31), 0)
    upper = torch.zeros((rows, uw + 1), dtype=torch.int64,
                        device=buckets.device).scatter_add_(1, word, bit)
    del pos, word, bit      # (R, cap) int64 each: 4.3 GB apiece at q4_sj
    parts = [compression.to_i32(upper[:, :uw])]
    if l:
        lo = torch.where(bucket_mask, offs & ((1 << l) - 1), 0)
        parts.append(compression.pack_bits(lo, l))
    parts.append(mask_fold(bucket_mask))
    return torch.cat(parts, dim=1)


def ef_decode(words, base, capacity, domain):
    """Rank/select EF decoder (inverse of :func:`ef_encode`): bit-expand the
    upper bitvector, rank its set bits with one cumsum, scatter each one's
    position to its slot.  Returns (keys (R, capacity) int32 =
    ``base[r] + offset``, 0 on masked slots; mask (R, capacity) bool)."""
    rows = words.shape[0]
    l, uw, lw = compression.ef_params(capacity, domain)
    upper = compression.unpack_bitset(words[:, :uw], uw * 32).to(torch.int64)
    rank = torch.cumsum(upper, dim=1)
    tgt = torch.where(upper.bool(), rank - 1, capacity).clamp(max=capacity)
    posv = torch.arange(uw * 32, device=words.device).expand(rows, -1)
    sel = torch.zeros((rows, capacity + 1), dtype=torch.int64,
                      device=words.device).scatter_add_(1, tgt, posv)
    del upper, rank, tgt    # (R, uw * 32) int64 each
    hi = sel[:, :capacity] - torch.arange(capacity, device=words.device)
    if l:
        lo = compression.unpack_bits(words[:, uw:uw + lw], capacity,
                                     l).to(torch.int64)
    else:
        lo = torch.zeros_like(hi)
    mask = mask_unfold(
        words[:, uw + lw:uw + lw + compression.bitset_words(capacity)],
        capacity)
    keys = base.to(torch.int64)[:, None] + ((hi << l) | lo)
    return torch.where(mask, keys, 0).to(torch.int32), mask


# ---------------------------------------------------------------------------
# block top-k (§3.2.3 step 1), predicate bitset (§3.2.2 Alt-2 build side),
# m-bit partial-sum codec (§3.2.5).  Leading dimensions are rows: each row
# is padded and packed on its own, from element 0.
# ---------------------------------------------------------------------------

I32_MAX = 2 ** 31 - 1


def block_topk(values, keys, k, mask=None, block: int = 4096):
    """Per-block top-k by k masked-argmax sweeps: (..., N) f32 values and
    int32 keys -> ((..., ceil(N / block), k) f32, int32 keys).  Masked rows
    and pads are -inf, pads carry key INT32_MAX; a sweep takes the first
    (lowest-index) maximum and sets it to -inf, so a block that runs out
    of finite rows repeats the key of its row 0."""
    v = values.to(torch.float32)
    if mask is not None:
        v = torch.where(mask, v, float("-inf"))
    pad = (-v.shape[-1]) % block
    v = torch.nn.functional.pad(v, (0, pad), value=float("-inf"))
    kp = torch.nn.functional.pad(keys.to(torch.int32), (0, pad),
                                 value=I32_MAX)
    vb = v.reshape(v.shape[:-1] + (-1, block)).clone()
    kb = kp.reshape(vb.shape)
    out_v, out_k = [], []
    for _ in range(k):
        m, am = vb.max(dim=-1, keepdim=True)   # first occurrence
        out_v.append(m[..., 0])
        out_k.append(torch.gather(kb, -1, am)[..., 0])
        vb.scatter_(-1, am, float("-inf"))
    return torch.stack(out_v, dim=-1), torch.stack(out_k, dim=-1)


def predicate_bitset(column, value):
    """Packed bitset of ``column == value``: (..., N) -> (...,
    ceil(N / 32)) int32 words, LSB first, pad bits 0."""
    bits = column == value
    pad = (-bits.shape[-1]) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    return compression.pack_bitset(bits)


def _bit_length(x):
    """Significant bits of non-negative int64 values (0 for 0), by the
    kernels' log2-free ladder."""
    bits = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        above = x >= (1 << shift)
        bits = torch.where(above, bits + shift, bits)
        x = torch.where(above, x >> shift, x)
    return bits + (x > 0).to(x.dtype)


def mbit_codes(q, m, group):
    """The §3.2.5 codes before packing: per ``group`` consecutive values of
    a row, ``shift = max(0, bits(max) - m)`` and ``code = q >> shift``.
    q: (..., K) non-negative int32 (uint32 values < 2**31), K % group == 0.
    Returns codes (..., K) int32 < 2**m and shifts (..., K / group)
    int32."""
    K = q.shape[-1]
    if K % group:
        raise ValueError(f"group {group} does not divide {K}")
    g = compression.as_u32(q).reshape(q.shape[:-1] + (K // group, group))
    shift = (_bit_length(g.amax(dim=-1)) - m).clamp(min=0)
    codes = (g >> shift[..., None]).reshape(q.shape)
    return codes.to(torch.int32), shift.to(torch.int32)


def mbit_encode(q, m, group):
    """:func:`mbit_codes` packed LSB first at m bits, each row from bit 0:
    (..., K) -> (words (..., ceil(K m / 32)) int32, shifts (..., K /
    group) int32).  m must divide 32."""
    if 32 % m:
        raise ValueError(f"m={m} must divide 32")
    codes, shifts = mbit_codes(q, m, group)
    return compression.pack_bits(codes, m), shifts


def code_bounds(codes, shifts, group):
    """Lower and upper bounds of the values behind codes (..., K) under
    their group shifts (..., K / group): ``code << s`` and ``+ 2**s - 1``,
    int64 holding the uint32 values."""
    s = torch.repeat_interleave(shifts.to(torch.int64), group, dim=-1)
    lower = compression.as_u32(codes) << s
    return lower, lower + (1 << s) - 1


def mbit_decode_bounds(words, shifts, m, group):
    """Inverse of :func:`mbit_encode` to bounds: (..., W) words and (...,
    G) shifts -> (lower, upper) (..., G * group) int64."""
    codes = compression.unpack_bits(words, shifts.shape[-1] * group, m)
    return code_bounds(codes, shifts, group)


# ---------------------------------------------------------------------------
# attention (B7 flash forward, B8 its backward, B9 decode): full
# materialisation with the kernels' guards.  Float32 arithmetic; f32
# products must not run in TF32 (torch.backends.cuda.matmul.allow_tf32
# False, PyTorch's default).
# ---------------------------------------------------------------------------

NEG_INF = float(torch.finfo(torch.float32).min)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _masked_softmax_parts(s):
    """(p, l, m) of scores ``s`` with NEG_INF at masked keys, the kernels'
    guards: p = 0 where s <= NEG_INF / 2, so a fully masked row has
    m = NEG_INF and l = 0."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    return p, p.sum(dim=-1), m[..., 0]


def _masked_scores(qg, kg, causal, window, prefix):
    """f32 scores ``(q / sqrt(D)) . k`` (BKV, G, S, Sk), NEG_INF where
    query i does not see key j: when ``causal``, it sees ``j <= i`` (and
    ``j > i - window`` with a window) or ``j < prefix``."""
    S, D = qg.shape[2], qg.shape[3]
    Sk = kg.shape[1]
    qf = qg.float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bgsd,btd->bgst", qf, kg.float())
    if causal:
        q_pos = torch.arange(S, device=qg.device)[:, None]
        k_pos = torch.arange(Sk, device=qg.device)[None, :]
        vis = k_pos <= q_pos
        if window is not None:
            vis &= k_pos > q_pos - window
        if prefix:
            vis |= k_pos < prefix
        s = torch.where(vis, s, NEG_INF)
    return s


# relative difference that f32 arithmetic summed in another order may put
# between a kernel's p or ds and the plain version's (measured below
# 7e-6 on random bf16 inputs); within it of a rounding boundary, either
# rounding is right
ROUNDING_EPS = 2.0 ** -16


def rounding_slack(x, p_dtype, band=None):
    """Where ``x`` lies within ``band`` (default ``ROUNDING_EPS |x|``) of a
    rounding boundary of ``p_dtype``, the distance between the roundings
    of ``x - band`` and ``x + band``; else 0.  A kernel that rounds the
    same ``x`` computed in another order may fall anywhere in between."""
    if band is None:
        band = ROUNDING_EPS * x.abs()
    return ((x + band).to(p_dtype).float()
            - (x - band).to(p_dtype).float())


# difference that summing the same f32 terms in another order (the tensor
# cores' or PyTorch's) may make, in units of roundoff (2^-24) of the sum of
# the terms' magnitudes; one unit admitted every dq and dk of the
# qwen2.5-3b training inputs, four leave a margin
SUM_NOISE_ULPS = 4.0


def flash_attention_fwd(qg, kg, vg, causal=True, window=None, prefix=0,
                        p_dtype=None, slack=False):
    """Grouped GQA attention: q (BKV, G, S, D), k and v (BKV, Sk, D) ->
    (out (BKV, G, S, D) in q's dtype, lse (BKV, G, S) f32), masked as
    :func:`_masked_scores` says.  ``out = acc / max(l, 1e-30)`` (0 on a
    fully masked row), ``lse = m + log(max(l, 1e-30))``.

    ``p_dtype`` (bf16 or f16) repeats the tensor-core kernel's rounding:
    p is taken in base 2 against the integer row max ``M = ceil(max s
    log2 e)``, ``p = 2^(s log2 e - M)``, and rounded to ``p_dtype`` before
    ``p v``; l sums the unrounded p and ``lse = M ln 2 + log(max(l,
    1e-30))``.  With ``slack`` it also returns the bound on what rounding
    ``p`` on the other side of a boundary moves ``out``
    (:func:`rounding_slack` through ``|v| / l``)."""
    if slack and p_dtype is None:
        raise ValueError("slack needs a p_dtype")
    s = _masked_scores(qg, kg, causal, window, prefix)
    if p_dtype is None:
        p, l, m = _masked_softmax_parts(s)
        del s
        out = torch.einsum("bgst,btd->bgsd", p, vg.float())
        out = out / torch.clamp(l, min=1e-30)[..., None]
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        return out.to(qg.dtype), lse
    m = s.amax(dim=-1, keepdim=True)
    empty = m <= NEG_INF / 2
    m = torch.where(empty, 0.0, torch.ceil(m * LOG2E))
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp2(s * LOG2E - m))
    del s
    l = p.sum(dim=-1)
    den = torch.clamp(l, min=1e-30)[..., None]
    out = torch.einsum("bgst,btd->bgsd", p.to(p_dtype).float(),
                       vg.float()) / den
    lse = torch.where(empty[..., 0], NEG_INF, m[..., 0] * LN2)
    lse = lse + torch.log(den[..., 0])
    if not slack:
        return out.to(qg.dtype), lse
    sl = torch.einsum("bgst,btd->bgsd", rounding_slack(p, p_dtype),
                      vg.float().abs()) / den
    return out.to(qg.dtype), lse, sl


def flash_attention_bwd(qg, kg, vg, out, lse, do, causal=True, window=None,
                        prefix=0, p_dtype=None, slack=False):
    """The flash backward written out (not autograd of the forward), the
    TPU kernel's arithmetic in f32: ``delta = rowsum(do . out)``,
    ``p = exp(s - lse)`` with p = 0 where ``s <= NEG_INF / 2`` (a fully
    masked row gives zero gradients), ``ds = p (dp - delta)`` with
    ``dp = do . v``; ``dq = ds k / sqrt(D)``, ``dk = ds^T q / sqrt(D)``
    and ``dv = p^T do``, dk and dv summed over the G query heads of a kv
    row.  q, out, do (BKV, G, S, D), k and v (BKV, Sk, D), lse (BKV, G, S)
    f32 -> (dq, dk, dv) in the inputs' dtype.

    ``p_dtype`` (bf16 or f16) repeats the tensor-core kernel's rounding:
    p is rounded to ``p_dtype`` before ``p^T do``, and ds (from the
    unrounded p) before ``ds k`` and ``ds^T q``.  With ``slack`` it also
    returns, for dq, dk and dv, the bound on what rounding p or ds on the
    other side of a boundary moves them (:func:`rounding_slack` through
    ``|k|``, ``|q|`` and ``|do|``).  ds's band adds p times
    ``SUM_NOISE_ULPS`` units of roundoff of ``|do| . |v| + |do| . |out|``:
    where dp and delta nearly cancel, another summation order moves ds by
    far more than ``ROUNDING_EPS`` of itself."""
    if slack and p_dtype is None:
        raise ValueError("slack needs a p_dtype")
    scale = 1.0 / math.sqrt(qg.shape[3])
    dof = do.float()
    delta = (dof * out.float()).sum(-1)
    s = _masked_scores(qg, kg, causal, window, prefix)
    p = torch.exp(s - lse[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    del s
    pr = p if p_dtype is None else p.to(p_dtype).float()
    dv = torch.einsum("bgst,bgsd->btd", pr, dof)
    del pr
    if slack:
        sl_dv = torch.einsum("bgst,bgsd->btd", rounding_slack(p, p_dtype),
                             dof.abs())
    ds = torch.einsum("bgsd,btd->bgst", dof, vg.float())
    if slack:
        dof_abs = dof.abs()
        noise = torch.einsum("bgsd,btd->bgst", dof_abs, vg.float().abs())
        noise += (dof_abs * out.float().abs()).sum(-1)[..., None]
        band = p * noise.mul_(SUM_NOISE_ULPS * 2.0 ** -24)
        del noise
    ds = p.mul_(ds.sub_(delta[..., None]))
    dsr = ds if p_dtype is None else ds.to(p_dtype).float()
    dq = torch.einsum("bgst,btd->bgsd", dsr, kg.float()) * scale
    dk = torch.einsum("bgst,bgsd->btd", dsr, qg.float()) * scale
    grads = (dq.to(qg.dtype), dk.to(kg.dtype), dv.to(vg.dtype))
    if not slack:
        return grads
    del dsr
    sd = rounding_slack(ds, p_dtype, band.add_(ROUNDING_EPS * ds.abs()))
    return grads, (torch.einsum("bgst,btd->bgsd", sd, kg.float().abs()) * scale,
                   torch.einsum("bgst,bgsd->btd", sd, qg.float().abs()) * scale,
                   sl_dv)


def decode_attention(q, k_cache, v_cache, length, k_scale=None,
                     v_scale=None):
    """One-token grouped attention: q (BKV, G, D) against caches
    (BKV, Smax, D), float or int8 with (BKV, Smax) f32 scales (then
    k = codes * k_scale); positions >= ``length`` (a 0-d int32 tensor on
    q's device, compared there: nothing reads it on the host) are
    masked.  Returns (BKV, G, D) in q's dtype, ``acc / max(l, 1e-30)``."""
    D = q.shape[-1]
    Smax = k_cache.shape[1]
    scale = 1.0 / math.sqrt(D)
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    s = torch.einsum("bgd,bsd->bgs", q.float() * scale, kf)
    pos = torch.arange(Smax, device=q.device)
    s = torch.where(pos < length, s, NEG_INF)
    p, l, _ = _masked_softmax_parts(s)
    out = torch.einsum("bgs,bsd->bgd", p, vf)
    return (out / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
