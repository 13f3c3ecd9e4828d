"""Mamba2 blocks by the SSD (state-space duality) algorithm
[arXiv:2405.21060].

Counterpart of ``repro.models.ssm``. Prefill runs the chunked SSD form:
attention-like products within a chunk of the sequence, then a
recurrence over the chunks' states (a Python loop here, a ``lax.scan``
in the reference). Decode is the O(1) recurrent update of one token.
:func:`forward_seq` and :func:`decode_step` run a stack of these blocks,
for the SSM family and, with the shared attention block hooked in after
its layers, for the hybrid (:mod:`repro_torch.models.hybrid`).
The reference has no Pallas kernel on this path. Prefill runs plain
torch ops; a decode step runs its conv and its state update as two
hand-written kernels (:func:`~repro_torch.kernels.fused.kernel.
ssm_conv_step`, :func:`~repro_torch.kernels.fused.kernel.ssd_step`), which
update the layer's conv cache and state in place, and its norms through
the ``rms_norm`` kernel. :func:`conv_step` and :func:`ssd_decode_step`
(out of place) are those kernels' plain versions. The two projections of
a block, ``w_in`` and ``w_out``, go through
:func:`repro_torch.quant.apply.linear_apply` and so reach the
int8/nf4 kernels under those formats.

The rounding points are the reference's: the conv and the scan run in
f32, and their outputs are cast to the activation dtype where the
reference casts them.

Layer parameter layout::

    w_in      : (D, d_in_proj)   packed [z | x | B | C | dt]
    w_out     : (d_inner, D)
    conv_w    : (conv_width, conv_channels)   depthwise causal conv
    conv_b    : (conv_channels,)
    A_log, D, dt_bias : (nheads,)
    norm      : (D,)            pre-norm gamma
    gate_norm : (d_inner,)      RMSNorm before the out projection
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.sharded import by_table, gather_last, is_sharded
# conv_step and ssd_decode_step (out of place) are the plain versions
# of the decode step's ssm_conv_step and ssd_step
from repro_torch.kernels.fused.kernel import (  # noqa: F401
    conv_step, ssd_decode_step, ssd_step, ssm_conv_step)
from repro_torch.models.layers import rms_norm
from repro_torch.quant.apply import linear_apply

#: the SSD scan's chunk length, the reference's; a sequence it does not
#: divide is one chunk
SSD_CHUNK = 64


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    di = cfg.d_inner
    ng, ds, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    return dict(
        d_inner=di, nheads=nh, headdim=cfg.ssm_headdim, dstate=ds,
        ngroups=ng,
        conv_channels=di + 2 * ng * ds,
        d_in_proj=2 * di + 2 * ng * ds + nh,
    )


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d = ssm_dims(cfg)
    di = d["d_inner"]
    if is_sharded(zxbcdt):
        zxbcdt = gather_last(zxbcdt)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + d["conv_channels"]]
    dt = zxbcdt[..., di + d["conv_channels"]:]
    return z, xBC, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C): f32 taps
    summed in tap order, SiLU, cast to xBC's dtype."""
    K, S = conv_w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):
        out = out + pad[:, i:i + S, :].float() * conv_w[i].float()
    return F.silu(out + conv_b.float()).to(xBC.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x (b, S, nh, hd) post-conv inputs; dt (b, S, nh) post-softplus; A
    (nh,) negative decay rates; B, C (b, S, ng, ds); D (nh,) skip; h0
    (b, nh, hd, ds) incoming state. Returns (y (b, S, nh, hd) in x's
    dtype, final state f32). A sequence that SSD_CHUNK does not divide
    is one chunk of S, as in the reference. The decay exp(l_i - l_j) is
    infinite above the diagonal of a long chunk: the exponent is set to
    0 there before the exp and the product dropped by a select after it,
    never multiplied by a 0/1 mask (inf * 0 would be NaN). The select
    before the exp keeps the gradient finite: the reference exponentiates
    the raw differences, and its gradient through the dropped entries is
    0 * inf = NaN (ROADMAP C11); the kept entries, and so the forward,
    are the same bit for bit."""
    b, S, nh, hd = x.shape
    ng, ds = B.shape[2], B.shape[3]
    chunk = S if S % SSD_CHUNK else SSD_CHUNK
    nc = S // chunk
    rep = nh // ng

    xc = x.reshape(b, nc, chunk, nh, hd)
    dtc = dt.reshape(b, nc, chunk, nh)
    Bc = B.reshape(b, nc, chunk, ng, ds)
    Cc = C.reshape(b, nc, chunk, ng, ds)

    dA = dtc * A[None, None, None, :]                  # (b,nc,L,nh) (<=0)
    l = torch.cumsum(dA, dim=2)                        # log-decay cumsum
    l_last = l[:, :, -1:, :]                           # (b,nc,1,nh)

    # intra-chunk: att[i,j] = (C_i . B_j) * exp(l_i - l_j), j <= i
    CB = torch.einsum("bnigs,bnjgs->bngij", Cc.float(), Bc.float())
    CB = CB.repeat_interleave(rep, dim=2)              # (b,nc,nh,L,L)
    lt = l.permute(0, 1, 3, 2)                         # (b,nc,nh,L)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    decay = torch.exp(torch.where(causal, lt[..., :, None]
                                  - lt[..., None, :], zero))
    att = torch.where(causal, CB * decay, zero)
    xdt = xc.float() * dtc[..., None]                  # (b,nc,L,nh,hd)
    y_intra = torch.einsum("bngij,bnjgh->bnigh", att, xdt)

    # chunk states: S_n = sum_j exp(l_last - l_j) B_j (x dt)_j
    w = torch.exp(l_last - l)                          # (b,nc,L,nh)
    Br = Bc.repeat_interleave(rep, dim=3)              # (b,nc,L,nh,ds)
    S_chunk = torch.einsum("bnjgh,bnjgs->bnghs", xdt * w[..., None],
                           Br.float())

    # inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(l_last[:, :, 0, :])        # (b,nc,nh)
    h = h0.float()
    h_before = []
    for n in range(nc):
        h_before.append(h)                             # state BEFORE chunk
        h = h * chunk_decay[:, n, :, None, None] + S_chunk[:, n]
    h_before = torch.stack(h_before, dim=1)            # (b,nc,nh,hd,ds)

    # inter-chunk output: y_i += C_i . (h_before * exp(l_i))
    Cr = Cc.repeat_interleave(rep, dim=3)              # (b,nc,L,nh,ds)
    y_inter = torch.einsum("bnigs,bnghs->bnigh",
                           Cr.float() * torch.exp(l)[..., None], h_before)
    y = y_intra + y_inter + xc.float() * D[None, None, None, :, None]
    return y.reshape(b, S, nh, hd).to(x.dtype), h.float()


# Where each argument, then each output, of the SSM's prefill ops is
# split in the dry run (core.sharded.by_table): (its dim on a mesh axis
# that splits the rows, its dim on the "model" axis when that divides the
# heads or channels); None: replicated.
_CONV = ((0, None, None, 0),                   # xBC, conv_w, conv_b -> y
         (2, 1, 0, 2))
_SSD = ((0, 0, None, 0, 0, None, 0, 0, 0),         # x dt A B C D h0 -> y h
        (2, 2, 0, None, None, 0, 1, 2, 1))


def _heads(xBC: torch.Tensor, d: Dict[str, int], lead):
    """(x (*lead, nh, hd), B, C (*lead, ng, ds)) from the conv output."""
    di, gs = d["d_inner"], d["ngroups"] * d["dstate"]
    if is_sharded(xBC):
        xBC = gather_last(xBC)
    return (xBC[..., :di].reshape(*lead, d["nheads"], d["headdim"]),
            xBC[..., di:di + gs].reshape(*lead, d["ngroups"], d["dstate"]),
            xBC[..., di + gs:].reshape(*lead, d["ngroups"], d["dstate"]))


def _gated_out(p: Dict[str, Any], y: torch.Tensor, z: torch.Tensor,
               policy: PrecisionPolicy) -> torch.Tensor:
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"])
    return linear_apply(p["w_out"], y, policy)


def mamba_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                policy: PrecisionPolicy, h0: torch.Tensor,
                seq_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full Mamba2 block over a sequence. x: (B, S, D).

    ``seq_mask`` (B, S): 1 for real tokens, 0 for right-padding. Padded
    steps get dt = 0 (decay 1, no input), so the final state is the state
    after each row's last real token. Returns (out, final ssm state,
    conv tail), the tail being the last conv_width - 1 raw conv inputs of
    each row's real sequence (gathered at its true length, zero where the
    row is shorter): the decode-time conv cache."""
    d = ssm_dims(cfg)
    res = x
    xn = rms_norm(x, p["norm"])
    zxbcdt = linear_apply(p["w_in"], xn, policy)
    z, xBC, dt = _split_in_proj(zxbcdt, cfg)
    K = cfg.ssm_conv_width
    b, S = x.shape[0], x.shape[1]
    row_len = seq_mask.sum(dim=1).to(torch.int64)               # (B,)
    idx = row_len[:, None] - (K - 1) \
        + torch.arange(K - 1, device=x.device)[None, :]
    valid = (idx >= 0) & (idx < S)
    tail = torch.gather(
        xBC, 1, idx.clamp(0, S - 1)[:, :, None].expand(-1, -1,
                                                        xBC.shape[-1]))
    tail = tail * valid[:, :, None].to(tail.dtype)
    xs, Bs, Cs = _heads(by_table(causal_conv, _CONV, xBC, p["conv_w"],
                                 p["conv_b"]), d, (b, S))
    dt = _softplus(dt.float() + p["dt_bias"].float()) \
        * seq_mask[..., None].float()
    A = -torch.exp(p["A_log"].float())
    y, h = by_table(ssd_chunked, _SSD, xs, dt, A, Bs, Cs, p["D"].float(),
                    h0)
    out = _gated_out(p, y.reshape(b, S, d["d_inner"]), z, policy)
    return res + out, h, tail


def mamba_block_decode(p: Dict[str, Any], x: torch.Tensor,
                       cfg: ModelConfig, policy: PrecisionPolicy,
                       h: torch.Tensor, conv_cache: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token Mamba2 step. x (B, D); h (B, nh, hd, ds) f32;
    conv_cache (B, K-1, conv_channels). h and conv_cache are updated in
    place (a layer's views of the stacked cache). Returns (out, h, conv
    cache)."""
    d = ssm_dims(cfg)
    b = x.shape[0]
    res = x
    xn = rms_norm(x, p["norm"])
    zxbcdt = linear_apply(p["w_in"], xn, policy)
    z, xBC, dt = _split_in_proj(zxbcdt, cfg)
    xBC = ssm_conv_step(xBC, conv_cache, p["conv_w"], p["conv_b"])
    xs, Bs, Cs = _heads(xBC, d, (b,))
    g = ssd_step(xs, Bs, Cs, z.reshape(b, d["nheads"], d["headdim"]), dt,
                 p["dt_bias"], p["A_log"], p["D"], h)
    y = rms_norm(g.reshape(b, d["d_inner"]), p["gate_norm"])
    return res + linear_apply(p["w_out"], y, policy), h, conv_cache


#: ``after_layer(i, x) -> x``: what a stack runs after its layer i (the
#: hybrid's shared attention block at its sites)
AfterLayer = Optional[Callable[[int, torch.Tensor], torch.Tensor]]


def forward_seq(layers, x: torch.Tensor, cfg: ModelConfig,
                policy: PrecisionPolicy, lengths: torch.Tensor,
                after_layer: AfterLayer = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The Mamba2 stack over a right-padded sequence x (B, S, D) whose
    rows hold ``lengths`` real tokens. Returns (hidden, the decode cache:
    ``ssm_state`` (L, B, nh, hd, ds) f32, ``conv`` (L, B, K-1, C) and
    ``pos``, a copy of lengths: decode advances it in place)."""
    dims = ssm_dims(cfg)
    B, S = x.shape[0], x.shape[1]
    h0 = torch.zeros((B, dims["nheads"], dims["headdim"], dims["dstate"]),
                     dtype=torch.float32, device=x.device)
    seq_mask = (torch.arange(S, device=x.device)[None, :]
                < lengths[:, None]).float()
    hs, tails = [], []
    for i, lp in enumerate(layers):
        x, h, tail = mamba_block(lp, x, cfg, policy, h0, seq_mask)
        hs.append(h)
        tails.append(tail)
        if after_layer is not None:
            x = after_layer(i, x)
    return x, {"ssm_state": torch.stack(hs), "conv": torch.stack(tails),
               "pos": lengths.to(torch.int32, copy=True)}


def decode_step(layers, x2d: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig, policy: PrecisionPolicy,
                after_layer: AfterLayer = None) -> torch.Tensor:
    """One token x2d (B, D) through the Mamba2 stack. ``cache`` (see
    :func:`forward_seq`) is updated in place, ``pos`` advanced by one.
    Returns the hidden state (B, D)."""
    for i, lp in enumerate(layers):
        x2d = mamba_block_decode(lp, x2d, cfg, policy, cache["ssm_state"][i],
                                 cache["conv"][i])[0]
        if after_layer is not None:
            x2d = after_layer(i, x2d)
    cache["pos"].add_(1)
    return x2d


def init_mamba_layer(generator: torch.Generator, cfg: ModelConfig,
                     dtype) -> Dict[str, Any]:
    """One layer's parameters, the reference's shapes and scales, drawn
    in f32 on the generator's device."""
    d = ssm_dims(cfg)
    D, dev = cfg.d_model, generator.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev) * scale).to(dtype)

    nh = d["nheads"]
    return {
        "norm": torch.ones((D,), dtype=dtype, device=dev),
        "w_in": normal((D, d["d_in_proj"]), D ** -0.5),
        "w_out": normal((d["d_inner"], D), d["d_inner"] ** -0.5),
        "conv_w": normal((cfg.ssm_conv_width, d["conv_channels"]), 0.3),
        "conv_b": torch.zeros((d["conv_channels"],), dtype=dtype,
                              device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
        .to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, nh, device=dev))).to(dtype),
        "gate_norm": torch.ones((d["d_inner"],), dtype=dtype, device=dev),
    }
