"""The model's fused elementwise passes: RMS normalisation, RoPE over q
and k, the gated activation ``silu(g) * u``, and the Mamba2 decode
step's conv and state update, each a CUDA C++ kernel for Hopper bound
with ctypes, beside its plain PyTorch version.

No Pallas kernel stands behind them. The reference's ``rms_norm``,
``apply_rope`` and ``jax.nn.silu(g) * u`` (``src/repro/models/layers.py``)
are jnp chains that XLA fuses into one or two fusions each under
``jax.jit`` (``src/repro/serving/backend.py``, ``_jit_decode`` and
``_jit_prefill``). The plain versions here are the port's eager ops
(about 9 kernels a norm, 18 a tensor's RoPE, 2 a gated activation); the
kernels (``csrc/rms_norm.cu``,
``csrc/rope.cu``, ``csrc/silu_mul.cu``, built at first use by
:mod:`repro_torch.kernels.cuda_build`) are one launch a call each, with
the plain versions' rounding points:

- :func:`rms_norm`: x (..., D) bf16 or f32, gamma (D,) f32, bf16 or fp16;
  f32 sum of squares, ``rsqrt(mean + eps)``, ``(x * r) * gamma``, one
  rounding to x's dtype.
- :func:`rope_qk`: q (B, S, H, hd) and k (B, S, Kv, hd) of one dtype (bf16
  or f32; the last axis contiguous, the others any stride), positions
  (B, S) or (S,) int32 or int64, both rotated in one launch; the angle
  ``float(pos) * freq`` in f32 over the frequency table
  :func:`cached_frequencies` keeps per (head_dim, theta, device), filled
  by :func:`rope_frequencies`' own ops, so its bits are the plain
  version's; precise sin and cos; each product and sum rounded as torch
  rounds them.
- :func:`silu_mul`: g and u of one shape and dtype (bf16 or f32);
  ``silu(g)`` rounded to the dtype, then the product rounded.
- :func:`ssm_conv_step` (``csrc/ssm_conv_step.cu``): one token's
  depthwise causal conv, the counterpart of the reference's
  ``conv_step`` (``src/repro/models/ssm.py:67``); x (B, C), a view of
  the input projection (any row stride), the layer's conv cache (B,
  K - 1, C) shifted in place; the K taps summed in f32 in tap order, the
  bias, SiLU, one rounding.
- :func:`ssd_step` (``csrc/ssd_step.cu``): one token's SSD state update
  and gated output, the counterpart of the reference's
  ``ssd_decode_step`` (``src/repro/models/ssm.py:154``) with the dt, A
  and gate lines of ``mamba_block_decode`` (:249-255); the f32 state
  (B, nh, hd, ds) updated in place, ``y = C . h + x * D`` rounded to the
  activation dtype, ``silu(z)`` rounded, their product rounded.

The reference's decode step has no Pallas kernel either: XLA fuses these
chains under ``jax.jit(model.decode_step)`` (``src/repro/serving/
backend.py:451``), where the port ran about 45 eager ops a Mamba layer.

For a tensor on the CPU each returns its plain version. For a CUDA
tensor it checks device, dtypes, shapes and contiguity, raises on
anything the kernel does not take (nothing falls back to the plain
version), allocates the output, launches on the current stream, raises
if the launch reports an error, and adds one to ``LAUNCHES[name]``. The
kernels have no backward: on either device an input that requires grad
while grad mode is on raises (:func:`~repro_torch.kernels.cuda_build.
refuse_grad`); the model's layers send such a call through
:class:`~repro_torch.kernels.fused.ops.KernelWithPlainGrad`, whose
forward calls the wrapper with grad mode off and whose backward takes the
plain version's gradient. On the ``meta`` device under a
cost analysis (the dry run) each returns empty outputs and reports its
bytes and FLOPs (:mod:`repro_torch.kernels.cost`) to the active
:class:`~repro_torch.core.op_analysis.OpCounter`; on DTensors it runs on
each rank's shards, with the axis it reduces or rotates whole on every
rank.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import op_analysis
from repro_torch.core.sharded import by_table, is_sharded, on_shards
from repro_torch.kernels import cost, cuda_build
from repro_torch.kernels.cuda_build import I, P, check

CSRC = Path(__file__).resolve().parent / "csrc"
L = ctypes.c_longlong
HEADER = ("fused.cuh",)
# name -> library: rms_norm (x, gamma, out, rows, D, eps, x_kind, g_kind,
# vec); rope (q, k, q_out, k_out, pos, freq, B, S, H, Kv, hd, the
# strides of q, k and the positions, pos_i64, heads_per_block, is_bf16);
# silu_mul (g, u, out, n, vec, blocks, is_bf16); ssm_conv_step (x, cache,
# w, b, y, rows, C, K, x's row stride, x_kind, p_kind); ssd_step (x, B, C,
# z, dt, dt_bias, A_log, D, h, g, rows, nh, hd, ng, ds, the two outer
# strides of x, B, C and z and the row stride of dt, x_kind, p_kind)
SOURCES = {
    "rms_norm": cuda_build.Source(
        "rms_norm", CSRC, (P, P, P, I, I, cuda_build.F, I, I, I), HEADER),
    "rope_qk": cuda_build.Source(
        "rope", CSRC, (P,) * 6 + (I,) * 5 + (L,) * 8 + (I,) * 3, HEADER),
    "silu_mul": cuda_build.Source(
        "silu_mul", CSRC, (P, P, P, L, I, I, I), HEADER),
    "ssm_conv_step": cuda_build.Source(
        "ssm_conv_step", CSRC, (P,) * 5 + (I, I, I, L, I, I), HEADER),
    "ssd_step": cuda_build.Source(
        "ssd_step", CSRC, (P,) * 10 + (I,) * 5 + (L,) * 9 + (I, I),
        HEADER),
}
NAMES = tuple(SOURCES)

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {name: 0 for name in NAMES}
cuda_build.register_counts(LAUNCHES)

DTYPES = (torch.float32, torch.bfloat16)
GAMMA_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
POS_DTYPES = (torch.int32, torch.int64)
MAX_HEAD_DIM = 512          # the rope kernel's shared table: hd / 2 <= 256
SILU_THREADS = 256          # csrc/silu_mul.cu kThreads
BLOCKS_PER_SM = 2           # silu_mul's blocks a wave on every SM


def reset_launches() -> None:
    for name in NAMES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def rms_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). RoPE of one
    tensor, the plain version's half of :func:`rope_qk`."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs        # (..., s, half)
    cos = torch.cos(angles)[..., :, None, :]                # (..., s, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_qk_plain(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                  theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


def silu_mul_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return F.silu(g) * u


def conv_step(x_t: torch.Tensor, conv_cache: torch.Tensor, conv_w,
              conv_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token causal conv. x_t (B, C); conv_cache (B, K-1, C), the
    cached inputs oldest first; conv_w (K, C). The taps summed in f32 in
    tap order, plus conv_b, SiLU, rounded to x_t's dtype. Returns (output
    (B, C), the new cache (B, K-1, C))."""
    window = torch.cat([conv_cache, x_t[:, None, :]], dim=1)
    acc = torch.zeros(x_t.shape, dtype=torch.float32, device=x_t.device)
    for k in range(conv_w.shape[0]):
        acc = acc + window[:, k].float() * conv_w[k].float()
    return (F.silu(acc + conv_b.float()).to(x_t.dtype),
            window[:, 1:, :])


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent update for one token. x (b, nh, hd); dt (b, nh);
    B, C (b, ng, ds); h (b, nh, hd, ds) f32. Returns (y rounded to x's
    dtype, the new state)."""
    nh, ng = x.shape[1], B.shape[1]
    rep = nh // ng
    dA = torch.exp(dt * A[None, :])                    # (b, nh)
    Br = B.repeat_interleave(rep, dim=1)               # (b, nh, ds)
    Cr = C.repeat_interleave(rep, dim=1)
    xdt = x.float() * dt[..., None]
    h_new = h * dA[..., None, None] \
        + xdt[..., None] * Br[:, :, None, :].float()
    y = torch.einsum("bghs,bgs->bgh", h_new, Cr.float())
    y = y + x.float() * D[None, :, None]
    return y.to(x.dtype), h_new


def ssm_conv_step_plain(x: torch.Tensor, conv_cache: torch.Tensor,
                        conv_w: torch.Tensor,
                        conv_b: torch.Tensor) -> torch.Tensor:
    """:func:`conv_step` with the cache shifted in place: it then holds
    the last K - 1 inputs, x last."""
    y, shifted = conv_step(x, conv_cache, conv_w, conv_b)
    conv_cache.copy_(shifted)
    return y


def ssd_step_plain(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   z: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
                   A_log: torch.Tensor, D: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """x and z (b, nh, hd), B and C (b, ng, ds), dt (b, nh) in the
    activation dtype; dt_bias, A_log, D (nh,); the f32 state h (b, nh,
    hd, ds), updated in place. ``dt = softplus(dt + dt_bias)`` (as
    ``logaddexp(., 0)``), ``A = -exp(A_log)``, then
    :func:`ssd_decode_step`; its y times ``silu(z)`` rounded to x's
    dtype: the gated output (b, nh, hd) that the gate norm takes."""
    d = dt.float() + dt_bias.float()
    d = torch.logaddexp(d, torch.zeros_like(d))
    y, h_new = ssd_decode_step(x, d, -torch.exp(A_log.float()), B, C,
                               D.float(), h)
    h.copy_(h_new)
    return y * F.silu(z.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# the frequency table
# ---------------------------------------------------------------------------
#: (head_dim, theta, device) -> the f32 table of rope_frequencies, kept for
#: the life of the process, so that a CUDA graph captured over a rope
#: launch keeps a valid address
_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def cached_frequencies(head_dim: int, theta: float,
                       device: torch.device) -> torch.Tensor:
    """The table of :func:`rope_frequencies` on ``device``, made by its
    own ops the first time a (head_dim, theta, device) is asked for.
    Raises if that first time falls inside a CUDA graph capture, where the
    ops that would fill it do not run (the first eager step or prefill
    fills it)."""
    key = (head_dim, float(theta), torch.device(device))
    table = _FREQS.get(key)
    if table is None:
        if key[2].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the RoPE table for head_dim {head_dim}, theta {theta} on "
                f"{key[2]} is first asked for inside a CUDA graph capture; "
                f"run one call eagerly first")
        table = _FREQS[key] = rope_frequencies(head_dim, theta, key[2])
    return table


# ---------------------------------------------------------------------------
# plans, checks, the meta and sharded branches
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rope_plan(tokens: int, heads: int, n_sm: int) -> int:
    """Heads a rope block takes (one token a block): all of them once the
    tokens alone give a block to each of ``n_sm`` SMs, else runs small
    enough that tokens x runs come near it (decode: 4 tokens of llama's 40
    heads, 2 heads a block, 80 blocks)."""
    runs = max(1, min(heads, -(-n_sm // max(tokens, 1))))
    return -(-heads // runs)


def silu_mul_plan(n: int, vec: int, n_sm: int) -> int:
    """Blocks of the silu_mul grid: one a ``SILU_THREADS`` vectors, at most
    eight waves of ``BLOCKS_PER_SM`` a SM (the grid strides past that)."""
    return max(1, min(-(-(n // vec) // SILU_THREADS),
                      8 * BLOCKS_PER_SM * n_sm))


def _vec(es: int, n: int, *tensors: torch.Tensor) -> int:
    """16 / es elements an access where every tensor is 16-byte aligned and
    ``n`` (a row length, or 0) a multiple of that, else 1."""
    wide = 16 // es
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return wide if aligned and n % wide == 0 else 1


def check_rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> None:
    """Raise on anything the rms_norm kernel does not take (any device)."""
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"x of shape {tuple(x.shape)} has no axis to "
                         f"normalise")
    if x.dtype not in DTYPES:
        raise TypeError(f"no rms_norm kernel for x of dtype {x.dtype}; "
                        f"expected one of {DTYPES}")
    if gamma.dtype not in GAMMA_KINDS:
        raise TypeError(f"no rms_norm kernel for gamma of dtype "
                        f"{gamma.dtype}; expected one of "
                        f"{tuple(GAMMA_KINDS)}")
    check("gamma", gamma, gamma.dtype, (x.shape[-1],), x.device)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def check_rope(q: torch.Tensor, k: torch.Tensor,
               positions: torch.Tensor) -> None:
    """Raise on anything the rope kernel does not take (any device)."""
    if q.ndim != 4 or k.ndim != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"expected q (B, S, H, hd) and k (B, S, Kv, hd); "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, S, _, hd = q.shape
    if hd % 2 or not 2 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"no rope kernel for head_dim {hd}: it must be "
                         f"even and at most {MAX_HEAD_DIM}")
    if q.dtype not in DTYPES or k.dtype != q.dtype:
        raise TypeError(f"no rope kernel for q {q.dtype} and k {k.dtype}; "
                        f"expected both one of {DTYPES}")
    if positions.dtype not in POS_DTYPES:
        raise TypeError(f"positions of dtype {positions.dtype}; expected "
                        f"one of {POS_DTYPES}")
    if tuple(positions.shape) not in ((S,), (1, S), (B, S)):
        raise ValueError(f"positions of shape {tuple(positions.shape)}; "
                         f"expected ({S},) or ({B}, {S})")
    for name, t in (("k", k), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, expected {q.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("q and k need a contiguous last axis")


def check_silu_mul(g: torch.Tensor, u: torch.Tensor) -> None:
    """Raise on anything the silu_mul kernel does not take (any device)."""
    if g.dtype not in DTYPES:
        raise TypeError(f"no silu_mul kernel for dtype {g.dtype}; expected "
                        f"one of {DTYPES}")
    check("g", g, g.dtype, tuple(g.shape), g.device)
    check("u", u, g.dtype, tuple(g.shape), g.device)


def _meta_branch(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` is a meta tensor under a cost analysis."""
    if not (x.is_meta and op_analysis.counting()):
        raise ValueError(f"no {name} kernel for device {x.device}")


def _placements(t, n: int) -> list:
    from torch.distributed.tensor import Replicate
    return list(getattr(t, "placements", [Replicate()] * n))


def _mesh_ndim(*tensors) -> int:
    return next(t.device_mesh.ndim for t in tensors
                if hasattr(t, "device_mesh"))


def _whole(pl: list, dims) -> list:
    """``pl`` with each shard of one of ``dims`` and each pending sum made
    replicated: those axes whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if p.is_partial()
            or (isinstance(p, Shard) and p.dim in dims) else p for p in pl]


def _norm_on_shards(x, gamma, eps):
    from torch.distributed.tensor import Replicate
    n = _mesh_ndim(x, gamma)
    x_pl = _whole(_placements(x, n), (x.ndim - 1,))
    return on_shards(lambda x, g: rms_norm(x, g, eps), x_pl, x, gamma,
                     in_placements=[x_pl, [Replicate()] * n])


def _rope_on_shards(q, k, positions, theta):
    """q and k keep their head shards; their batch and sequence axes split
    alike (k follows q), as the positions then are."""
    from torch.distributed.tensor import Replicate, Shard
    n = _mesh_ndim(q, k, positions)
    q_pl = _whole(_placements(q, n), (3,))
    k_pl = _whole(_placements(k, n), (3,))
    p_pl = []
    for i, qp in enumerate(q_pl):
        lead = qp if isinstance(qp, Shard) and qp.dim < 2 else None
        kp = k_pl[i]
        if lead is not None:
            k_pl[i] = lead
        elif isinstance(kp, Shard) and kp.dim < 2:
            k_pl[i] = Replicate()
        if lead is None or (positions.ndim == 1 and lead.dim == 0):
            p_pl.append(Replicate())
        else:
            p_pl.append(Shard(lead.dim - (2 - positions.ndim)))
    return on_shards(lambda q, k, p: rope_qk(q, k, p, theta), (q_pl, k_pl),
                     q, k, positions, in_placements=[q_pl, k_pl, p_pl])


def _silu_on_shards(g, u):
    pl = _whole(_placements(g, _mesh_ndim(g, u)), ())
    return on_shards(silu_mul, pl, g, u, in_placements=[pl, pl])


def check_ssm_conv_step(x: torch.Tensor, conv_cache: torch.Tensor,
                        conv_w: torch.Tensor, conv_b: torch.Tensor) -> None:
    """Raise on anything the ssm_conv_step kernel does not take (any
    device)."""
    if x.ndim != 2 or conv_w.ndim != 2 or conv_w.shape[1] != x.shape[1] \
            or conv_w.shape[0] < 2:
        raise ValueError(f"expected x (B, C) and taps (K >= 2, C); got "
                         f"{tuple(x.shape)} and {tuple(conv_w.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"no ssm_conv_step kernel for x of dtype {x.dtype}; "
                        f"expected one of {DTYPES}")
    if conv_w.dtype not in GAMMA_KINDS:
        raise TypeError(f"no ssm_conv_step kernel for taps of dtype "
                        f"{conv_w.dtype}; expected one of "
                        f"{tuple(GAMMA_KINDS)}")
    (B, C), K = x.shape, conv_w.shape[0]
    check("conv_cache", conv_cache, x.dtype, (B, K - 1, C), x.device)
    check("conv_w", conv_w, conv_w.dtype, (K, C), x.device)
    check("conv_b", conv_b, conv_w.dtype, (C,), x.device)
    if x.stride(1) != 1:
        raise ValueError("x needs a contiguous channel axis")


def check_ssd_step(x, B, C, z, dt, dt_bias, A_log, D, h) -> None:
    """Raise on anything the ssd_step kernel does not take (any device)."""
    if x.ndim != 3 or B.ndim != 3:
        raise ValueError(f"expected x (b, nh, hd) and B (b, ng, ds); got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    b, nh, hd = x.shape
    ng, ds = B.shape[1], B.shape[2]
    if x.dtype not in DTYPES:
        raise TypeError(f"no ssd_step kernel for x of dtype {x.dtype}; "
                        f"expected one of {DTYPES}")
    if ng < 1 or nh % ng or ds % 4:
        raise ValueError(f"no ssd_step kernel for {nh} heads in {ng} "
                         f"groups with a state of {ds}: the groups must "
                         f"divide the heads and 4 the state")
    for name, t, shape in (("x", x, (b, nh, hd)), ("z", z, (b, nh, hd)),
                           ("B", B, (b, ng, ds)), ("C", C, (b, ng, ds)),
                           ("dt", dt, (b, nh))):
        if t.dtype != x.dtype or tuple(t.shape) != shape \
                or t.device != x.device:
            raise ValueError(f"{name} of {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; expected {x.dtype} {shape} on "
                             f"{x.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")
    if dt_bias.dtype not in GAMMA_KINDS:
        raise TypeError(f"no ssd_step kernel for parameters of dtype "
                        f"{dt_bias.dtype}; expected one of "
                        f"{tuple(GAMMA_KINDS)}")
    for name, t in (("dt_bias", dt_bias), ("A_log", A_log), ("D", D)):
        check(name, t, dt_bias.dtype, (nh,), x.device)
    check("h", h, torch.float32, (b, nh, hd, ds), x.device)


# Where each argument, then the output, of the SSM step kernels is split
# in the dry run (core.sharded.by_table): (its dim on a mesh axis that
# splits the rows, its dim on the "model" axis when that divides the
# heads or channels); None: replicated. The state and the conv cache are
# updated in place on their shards.
_CONV_STEP = ((0, 0, None, None, 0),                 # x, cache, w, b -> y
              (1, 2, 1, 0, 1))
# x, B, C, z, dt, dt_bias, A_log, D, h -> g
_SSD_STEP = ((0, 0, 0, 0, 0, None, None, None, 0, 0),
             (1, None, None, 1, 1, 0, 0, 0, 1, 1))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) normalised over its last axis -> x's shape and dtype."""
    cuda_build.refuse_grad("rms_norm", x, gamma)
    if x.device.type == "cpu":
        return rms_norm_plain(x, gamma, eps)
    if x.device.type != "cuda":
        if is_sharded(x, gamma):
            return _norm_on_shards(x, gamma, eps)
        _meta_branch("rms_norm", x)
        D = x.shape[-1]
        nbytes, flops = cost.rms_norm(x.numel() // D, D, x.element_size(),
                                      gamma.element_size())
        op_analysis.record("rms_norm", flops, nbytes)
        return torch.empty_like(x)
    check_rms_norm(x, gamma)
    out = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D
    if rows:
        cuda_build.launch(
            SOURCES["rms_norm"], LAUNCHES, x.data_ptr(), gamma.data_ptr(),
            out.data_ptr(), rows, D, eps, int(x.dtype == torch.bfloat16),
            GAMMA_KINDS[gamma.dtype], _vec(x.element_size(), D, x, out))
    return out


def rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
            theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd) and k (B, S, Kv, hd) rotated by ``positions`` (B, S)
    or (S,) -> (q, k), contiguous, in their dtype."""
    cuda_build.refuse_grad("rope_qk", q, k)
    if q.device.type == "cpu":
        return rope_qk_plain(q, k, positions, theta)
    if q.device.type != "cuda":
        if is_sharded(q, k, positions):
            return _rope_on_shards(q, k, positions, theta)
        _meta_branch("rope_qk", q)
        B, S, H, hd = q.shape
        nbytes, flops = cost.rope_qk(B * S, H, k.shape[2], hd,
                                     q.element_size(),
                                     positions.element_size(),
                                     positions.numel())
        op_analysis.record("rope_qk", flops, nbytes)
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty(k.shape, dtype=k.dtype, device=k.device))
    check_rope(q, k, positions)
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    q_out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    k_out = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    if B * S:
        freq = cached_frequencies(hd, theta, q.device)
        pos = positions.expand(B, S)
        cuda_build.launch(
            SOURCES["rope_qk"], LAUNCHES, q.data_ptr(), k.data_ptr(),
            q_out.data_ptr(), k_out.data_ptr(), pos.data_ptr(),
            freq.data_ptr(), B, S, H, Kv, hd, *q.stride()[:3],
            *k.stride()[:3], *pos.stride(),
            int(pos.dtype == torch.int64),
            rope_plan(B * S, H + Kv, _sm_count(q.get_device())),
            int(q.dtype == torch.bfloat16), key="rope_qk")
    return q_out, k_out


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) * u`` elementwise -> g's shape and dtype."""
    cuda_build.refuse_grad("silu_mul", g, u)
    if g.device.type == "cpu":
        return silu_mul_plain(g, u)
    if g.device.type != "cuda":
        if is_sharded(g, u):
            return _silu_on_shards(g, u)
        _meta_branch("silu_mul", g)
        nbytes, flops = cost.silu_mul(g.numel(), g.element_size())
        op_analysis.record("silu_mul", flops, nbytes)
        return torch.empty_like(g)
    check_silu_mul(g, u)
    out = torch.empty_like(g)
    n = g.numel()
    if n:
        vec = _vec(g.element_size(), 0, g, u, out)
        cuda_build.launch(
            SOURCES["silu_mul"], LAUNCHES, g.data_ptr(), u.data_ptr(),
            out.data_ptr(), n, vec,
            silu_mul_plan(n, vec, _sm_count(g.get_device())),
            int(g.dtype == torch.bfloat16))
    return out


def ssm_conv_step(x: torch.Tensor, conv_cache: torch.Tensor,
                  conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """One token x (B, C) (a view of the input projection: channels
    contiguous, any row stride) through the depthwise causal conv with
    the cached inputs (B, K - 1, C), which are shifted in place, taps
    conv_w (K, C) and bias conv_b (C,) -> (B, C) in x's dtype."""
    cuda_build.refuse_grad("ssm_conv_step", x, conv_cache, conv_w, conv_b)
    if x.device.type == "cpu":
        return ssm_conv_step_plain(x, conv_cache, conv_w, conv_b)
    if x.device.type != "cuda":
        if is_sharded(x, conv_cache, conv_w, conv_b):
            return by_table(ssm_conv_step, _CONV_STEP, x, conv_cache,
                            conv_w, conv_b)
        _meta_branch("ssm_conv_step", x)
        nbytes, flops = cost.ssm_conv_step(
            x.shape[0], x.shape[1], conv_w.shape[0], x.element_size(),
            conv_w.element_size())
        op_analysis.record("ssm_conv_step", flops, nbytes)
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    check_ssm_conv_step(x, conv_cache, conv_w, conv_b)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        cuda_build.launch(
            SOURCES["ssm_conv_step"], LAUNCHES, x.data_ptr(),
            conv_cache.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
            y.data_ptr(), x.shape[0], x.shape[1], conv_w.shape[0],
            x.stride(0), int(x.dtype == torch.bfloat16),
            GAMMA_KINDS[conv_w.dtype])
    return y


def ssd_step(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             z: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
             A_log: torch.Tensor, D: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """One token's SSD update of the f32 state h (b, nh, hd, ds), in
    place, and its gated output (b, nh, hd) in x's dtype (see
    :func:`ssd_step_plain`). x, z (b, nh, hd), B, C (b, ng, ds) and dt
    (b, nh) may be views of the conv output and the input projection:
    their last axis contiguous, the others any stride."""
    cuda_build.refuse_grad("ssd_step", x, B, C, z, dt, dt_bias, A_log, D,
                           h)
    if x.device.type == "cpu":
        return ssd_step_plain(x, B, C, z, dt, dt_bias, A_log, D, h)
    if x.device.type != "cuda":
        if is_sharded(x, B, C, z, dt, dt_bias, A_log, D, h):
            return by_table(ssd_step, _SSD_STEP, x, B, C, z, dt, dt_bias,
                            A_log, D, h)
        _meta_branch("ssd_step", x)
        nbytes, flops = cost.ssd_step(*x.shape, *B.shape[1:],
                                      x.element_size(), A_log.element_size())
        op_analysis.record("ssd_step", flops, nbytes)
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    check_ssd_step(x, B, C, z, dt, dt_bias, A_log, D, h)
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned")
    g = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        cuda_build.launch(
            SOURCES["ssd_step"], LAUNCHES, *(t.data_ptr() for t in (
                x, B, C, z, dt, dt_bias, A_log, D, h, g)),
            *x.shape, *B.shape[1:], *x.stride()[:2], *B.stride()[:2],
            *C.stride()[:2], *z.stride()[:2], dt.stride(0),
            int(x.dtype == torch.bfloat16), GAMMA_KINDS[A_log.dtype])
    return g
