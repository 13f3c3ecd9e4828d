"""The model's fused elementwise passes: RMS normalisation, RoPE over q
and k, and the gated activation ``silu(g) * u``, each a CUDA C++ kernel
for Hopper bound with ctypes, beside its plain PyTorch version.

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
from repro_torch.core.sharded import is_sharded, on_shards
from repro_torch.kernels import cost, cuda_build
from repro_torch.kernels.cuda_build import I, P, check

CSRC = Path(__file__).resolve().parent / "csrc"
L = ctypes.c_longlong
HEADER = ("fused.cuh",)
# name -> library: rms_norm (x, gamma, out, rows, D, eps, x_kind, g_kind,
# vec); rope (q, k, q_out, k_out, pos, freq, B, S, H, Kv, hd, the
# strides of q, k and the positions, pos_i64, heads_per_block, is_bf16);
# silu_mul (g, u, out, n, vec, blocks, is_bf16)
SOURCES = {
    "rms_norm": cuda_build.Source(
        "rms_norm", CSRC, (P, P, P, I, I, cuda_build.F, I, I, I), HEADER),
    "rope_qk": cuda_build.Source(
        "rope", CSRC, (P,) * 6 + (I,) * 5 + (L,) * 8 + (I,) * 3, HEADER),
    "silu_mul": cuda_build.Source(
        "silu_mul", CSRC, (P, P, P, L, I, I, I), HEADER),
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
