"""Mamba-2 (state-space duality) blocks, mamba2-2.7b (counterpart of
``repro.models.ssm``).

Chunked SSD: within a chunk the recurrence is a masked (attention-like)
contraction; across chunks a loop over the chunks carries the (H, P, N)
state, where the JAX package scans.  Decode is the O(1) recurrence: the
state has no position limit.

Shapes: d_inner = expand * d_model, H = d_inner / head_dim heads, N =
d_state, one B/C group.  Parameters are a
:class:`~repro_torch.models.transformer.Transformer` whose layers hold the
JAX tree's names (``norm``, ``w_zx``, ``w_bc``, ``w_dt``, ``dt_bias``,
``A_log``, ``D``, ``conv``, ``gated_norm``, ``out_proj``).  The decode
step writes the state in place, its device ``length`` too, and reads
nothing back, so ``serve.engine.decode_loop`` captures it in a CUDA
graph.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import param


# parameters the layer reads in f32 whatever the compute dtype (the JAX
# functions' ``.astype(jnp.float32)``): ``Model.cast`` keeps them in f32
F32_PARAMS = ("dt_bias", "A_log", "D", "gated_norm")


class SSMState(NamedTuple):
    state: torch.Tensor        # (layers, B, H, P, N) f32 running SSD state
    conv: torch.Tensor         # (layers, B, W-1, di + 2N) conv tail
    length: torch.Tensor       # 0-d int32 on the device: positions seen
    host_length: T.HostLength  # the same count on the host


def dims(cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = di // s.head_dim
    return di, H, s.d_state, s.head_dim, s.conv_width


def init_ssm_layer(cfg, gen: torch.Generator, dtype) -> dict:
    di, H, N, P, W = dims(cfg)
    d = cfg.d_model
    return {
        "norm": T._norm(gen, d, "rmsnorm", dtype),
        "w_zx": param((d, 2 * di), gen, axes=("embed", "mlp"), dtype=dtype),
        "w_bc": param((d, 2 * N), gen, axes=("embed", None), dtype=dtype),
        "w_dt": param((d, H), gen, axes=("embed", "heads"), dtype=dtype),
        "dt_bias": param((H,), gen, axes=("heads",), init="zeros",
                         dtype=dtype),
        "A_log": param((H,), gen, axes=("heads",), init="zeros",
                       dtype=dtype),
        "D": param((H,), gen, axes=("heads",), init="ones", dtype=dtype),
        "conv": param((W, di + 2 * N), gen, axes=("conv", "mlp"), scale=0.1,
                      dtype=dtype),
        "gated_norm": param((di,), gen, axes=("mlp",), init="ones",
                            dtype=dtype),
        "out_proj": param((di, d), gen, axes=("mlp", "embed"), dtype=dtype),
    }


def init_mamba(cfg, gen: torch.Generator,
               trainable: bool = False) -> T.Transformer:
    """Random parameters in ``cfg.param_dtype`` on ``gen``'s device, by
    the JAX package's init kinds and shapes (vocab padded, the embedding
    tied)."""
    dtype = getattr(torch, cfg.param_dtype)
    tree = {
        "embedding": T.embedding_tree(gen, cfg.padded_vocab(), cfg.d_model,
                                      dtype),
        "layers": [init_ssm_layer(cfg, gen, dtype)
                   for _ in range(cfg.n_layers)],
        "final_norm": T._norm(gen, cfg.d_model, "rmsnorm", dtype),
    }
    return T.Transformer(tree, trainable)


def _causal_conv(x, kernel):
    """x: (B, S, C); kernel: (W, C) depthwise causal, summed tap by tap
    in x's dtype as the JAX loop does."""
    W = kernel.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for w in range(W):
        out = out + xp[:, w:w + x.shape[1]] * kernel[w]
    return out


def _segsum_exp(a):
    """a: (..., Lc) log-decays -> the lower-triangular exp(sum a[j+1..i])
    matrix of shape (..., Lc, Lc)."""
    Lc = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]        # sum over (j, i]
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=a.device).tril()
    return torch.where(tri, torch.exp(diff), 0.0)


def ssd_chunked(x, dt, A, B, C, chunk: int, state0=None):
    """SSD scan.  x: (b, S, H, P); dt: (b, S, H) f32; A: (H,) negative;
    B, C: (b, S, N).  Returns (y (b, S, H, P) f32, final state
    (b, H, P, N) f32).  The products accumulate in f32 on inputs rounded
    to x's dtype where the JAX function rounds them (``gated``, ``xdt``,
    the decays): its ``preferred_element_type=f32``."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    io = x.dtype
    xc = x.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H)
    Bc = B.reshape(b, nc, chunk, N).float()
    Cc = C.reshape(b, nc, chunk, N).float()
    a = dtc * A                                        # (b,nc,Lc,H) log-decay
    a_cs = torch.cumsum(a, dim=2)                      # within-chunk cumsum
    a_total = a_cs[:, :, -1]                           # (b,nc,H)

    # intra-chunk: Lmat[b,c,h,i,j] = exp(a_cs[i] - a_cs[j]) for j <= i
    Lmat = _segsum_exp(a.transpose(2, 3))              # (b,nc,H,Lc,Lc)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    gated = (scores[:, :, None] * Lmat).to(io)
    del Lmat
    xdt = (xc.float() * dtc[..., None]).to(io)         # (b,nc,Lc,H,P)
    y = torch.einsum("bchij,bcjhp->bcihp", gated.float(), xdt.float())
    del gated

    # chunk-final states: sum_j B[j] exp(a_total - a_cs[j]) xdt[j]
    decay_to_end = torch.exp(a_total[:, :, None] - a_cs).to(io).float()
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc,
                          decay_to_end[..., None] * xdt.float())

    # inter-chunk recurrence, chunk by chunk
    s = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    decay = torch.exp(a_total)                         # (b,nc,H)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)              # (b,nc,H,P,N)
    decay_from_start = torch.exp(a_cs).to(C.dtype).float()   # (b,nc,Lc,H)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc,
                           s_prevs.to(C.dtype).float())
    y = y + y_inter * decay_from_start[..., None]
    return y.reshape(b, S, H, P), s


def _in_proj(p, h, cfg):
    """(z, x, B|C, dt): the input projections of normed ``h``; dt in f32
    through softplus."""
    di = dims(cfg)[0]
    zx = L._proj(h, p.w_zx)
    bc = L._proj(h, p.w_bc)
    dt = F.softplus(L._proj(h, p.w_dt).float() + p.dt_bias.float())
    return zx[..., :di], zx[..., di:], bc, dt


def _out(p, x, y, z):
    """The gate, the gated RMSNorm over d_inner and the out projection:
    y (B, S, di) f32 -> x + out."""
    cd = x.dtype
    y = y.to(cd) * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
         * p.gated_norm.float()).to(cd)
    return x + L._proj(y, p.out_proj)


def _ssm_body(p, x, cfg, chunk, io_dtype):
    """One layer's prefix shared by training and prefill: -> (x + out,
    final SSD state, the conv input)."""
    di, H, N, P, W = dims(cfg)
    chunk = L.fit_chunk(x.shape[1], chunk or cfg.ssm.chunk)
    h = L.apply_norm(p.norm, x, "rmsnorm")
    z, xin, bc, dt = _in_proj(p, h, cfg)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p.conv.to(x.dtype)))
    xin, B, C = (conv_out[..., :di], conv_out[..., di:di + N],
                 conv_out[..., di + N:])
    A = -torch.exp(p.A_log.float())
    xh = xin.reshape(*xin.shape[:2], H, P)
    y, sT = ssd_chunked(xh.to(io_dtype), dt, A, B.to(io_dtype),
                        C.to(io_dtype), chunk)
    y = y + xh.float() * p.D.float()[:, None]
    y = y.reshape(*xin.shape[:2], di)
    return _out(p, x, y, z), sT, conv_in


def apply_ssm_layer(p, x, cfg, *, chunk=None, bf16=False):
    """One training-forward layer: x (B, S, d) -> (B, S, d); the SSD in
    bf16 io where ``bf16``, else f32."""
    io = torch.bfloat16 if bf16 else torch.float32
    return _ssm_body(p, x, cfg, chunk, io)[0]


def forward(params: T.Transformer, tokens, cfg, *, chunk=None, bf16=False):
    """Training forward -> final hidden states (B, S, d), each layer
    under the remat policy (``jax.checkpoint`` in the JAX package)."""
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(params.embedding, tokens, cd)
    body = T.remat_wrap(functools.partial(apply_ssm_layer, cfg=cfg,
                                          chunk=chunk, bf16=bf16), cfg)
    for lp in params.layers:
        x = body(lp, x)
    return L.apply_norm(params.final_norm, x, "rmsnorm")


# ---------------------------------------------------------------------------
# O(1) decode
# ---------------------------------------------------------------------------


def init_state(cfg, batch: int, device, dtype=torch.float32) -> SSMState:
    di, H, N, P, W = dims(cfg)
    return SSMState(
        state=torch.zeros((cfg.n_layers, batch, H, P, N), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((cfg.n_layers, batch, W - 1, di + 2 * N),
                         dtype=dtype, device=device),
        length=T._zero_length(device), host_length=T.HostLength())


def apply_ssm_decode(p, x, cfg, state, conv_tail):
    """x: (B, 1, d); ``state`` (B, H, P, N) f32 and ``conv_tail``
    (B, W-1, C) of one layer, both updated in place.  Returns y."""
    di, H, N, P, W = dims(cfg)
    cd = x.dtype
    h = L.apply_norm(p.norm, x, "rmsnorm")
    z, xin, bc, dt = _in_proj(p, h, cfg)
    dt = dt[:, 0]                                      # (B, H)
    conv_in = torch.cat([xin, bc], dim=-1)             # (B, 1, C)
    wd = torch.promote_types(conv_tail.dtype, cd)
    window = torch.cat([conv_tail.to(wd), conv_in.to(wd)], dim=1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window,
                                   p.conv.to(cd).to(wd)))
    xin = conv_out[:, :di].reshape(-1, H, P)
    B_ = conv_out[:, di:di + N].float()
    C_ = conv_out[:, di + N:].float()
    A = -torch.exp(p.A_log.float())
    decay = torch.exp(dt * A)                          # (B, H)
    xdt = xin.float() * dt[..., None]
    new_state = (state * decay[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xdt, B_))
    y = torch.einsum("bhpn,bn->bhp", new_state, C_)
    y = y + xin.float() * p.D.float()[:, None]
    state.copy_(new_state)
    conv_tail.copy_(window[:, 1:])
    return _out(p, x, y.reshape(-1, 1, di), z)


def prefill(params: T.Transformer, tokens, cfg, state: SSMState, *,
            chunk=None):
    """Run the prompt (B, S) from a zero state, write each layer's final
    SSD state and conv tail (the last W - 1 conv inputs, zeros before the
    prompt) into ``state`` in place, set its length to S; return
    (last-position logits (B, vocab), the state)."""
    cd = getattr(torch, cfg.compute_dtype)
    W = dims(cfg)[4]
    x = L.embed(params.embedding, tokens, cd)
    S = x.shape[1]
    for i, lp in enumerate(params.layers):
        x, sT, conv_in = _ssm_body(lp, x, cfg, chunk, torch.float32)
        state.state[i].copy_(sT)
        state.conv[i].copy_(F.pad(conv_in, (0, 0, max(W - 1 - S, 0), 0))
                            [:, -(W - 1):])
    T.set_length(state, S)
    h = L.apply_norm(params.final_norm, x[:, -1:], "rmsnorm")
    logits = T.logits_from_hidden(params, h, cfg)
    return logits[:, 0], state


def decode_step(params: T.Transformer, state: SSMState, token, cfg):
    """One decode step: token (B, 1) -> (logits (B, vocab), state), the
    state's tensors and both lengths updated in place."""
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(params.embedding, token, cd)
    for i, lp in enumerate(params.layers):
        x = apply_ssm_decode(lp, x, cfg, state.state[i], state.conv[i])
    state.length.add_(1)
    state.host_length.n += 1
    h = L.apply_norm(params.final_norm, x, "rmsnorm")
    logits = T.logits_from_hidden(params, h, cfg)
    return logits[:, 0], state
