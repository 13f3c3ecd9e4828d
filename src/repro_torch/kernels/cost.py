"""The work of each hand-written kernel: one formula per kernel.

Each function returns (bytes, FLOPs) of one call from its shapes: the
bytes it must move (each input read once, each output written once) and
the multiply-add operations of its products (two FLOPs each), or for the
fused elementwise passes (``kernels/fused``) their f32 operations. The same
formulas price a kernel's bound in ``chip_smoke.py`` and its call in the
dry run (each wrapper's ``meta`` branch reports them to
:func:`repro_torch.core.op_analysis.record`), so the two cannot drift.
"""
from __future__ import annotations

from typing import Optional, Tuple


def quant_matmul(M: int, K: int, N: int, weight_bytes: int,
                 es: int = 2, E: int = 1, n_out: int = 0) -> Tuple[int, int]:
    """x (E, M, K) in the compute dtype (``es`` bytes an element) against
    E (K, N) weights of ``weight_bytes`` in all, out (E, M, N): the int8,
    nf4 and fp16 kernels. ``weight_bytes`` counts every field the kernel
    reads (int8: codes, scales and, with outliers, their int32 rows and
    bf16 weights; fp16: the fp16 weight); int8's ``n_out`` outlier rows
    add their product, x's outlier columns against the outlier weights,
    whose x bytes are among x's."""
    return (es * E * M * K + weight_bytes + es * E * M * N,
            2 * E * M * (K + n_out) * N)


def attention_pairs(S: int, T: int, causal: bool,
                    window: Optional[int] = None) -> int:
    """The (query, key) pairs a flash call computes: all S * T, or, causal
    (S <= T), those with key <= query and key > query - window."""
    if not causal:
        return S * T
    m = min(S, T)
    total = m * (m + 1) // 2 + max(0, S - T) * T
    if window is not None:            # less the keys at or below q - window
        n = max(0, S - window)
        total -= n * (n + 1) // 2
    return total


def flash_attention(B: int, S: int, T: int, H: int, Kv: int, d: int,
                    pairs: int, es: int) -> Tuple[int, int]:
    """q and out (B, S, H, d), k and v (B, T, Kv, d); two products over
    each of ``pairs`` (query, key) pairs per head."""
    return (es * (2 * B * S * H * d + 2 * B * T * Kv * d),
            4 * B * H * d * pairs)


def flash_attention_bwd(B: int, S: int, T: int, H: int, Kv: int, d: int,
                        pairs: int, es: int) -> Tuple[int, int]:
    """q, out, dout, dq (B, S, H, d), k, v, dk, dv (B, T, Kv, d) and the
    f32 logsumexp (B, H, S); five products over each pair per head."""
    return (es * (4 * B * S * H * d + 4 * B * T * Kv * d) + 4 * B * H * S,
            5 * 2 * d * pairs * B * H)


def paged_attention(B: int, H: int, Kv: int, d: int, n_valid: int,
                    table_entries: int, es: int, kv_es: Optional[int] = None,
                    scales: bool = False,
                    positions: bool = False) -> Tuple[int, int]:
    """q and out (B, H, d), the ``n_valid`` K/V slots the rows read
    (summed over the rows) at ``kv_es`` bytes an element (``es`` by
    default; 1 for int8 pages), with ``scales`` their f32 scales (one of
    K and one of V a slot and head), with ``positions`` each read slot's
    int32 position and the rows' ``pos``; the page table and the lengths
    (int32)."""
    kv_es = es if kv_es is None else kv_es
    return (es * 2 * B * H * d + kv_es * 2 * n_valid * Kv * d
            + (2 * 4 * n_valid * Kv if scales else 0)
            + (4 * (n_valid + B) if positions else 0)
            + 4 * (table_entries + B), 4 * H * d * n_valid)


def rms_norm(rows: int, D: int, es: int, gamma_es: int) -> Tuple[int, int]:
    """x and out (rows, D) at ``es`` bytes an element, gamma (D,) at
    ``gamma_es``; a square, a sum, a scale and a product an element (f32
    on the CUDA cores), and a mean and an rsqrt a row."""
    return es * 2 * rows * D + gamma_es * D, 4 * rows * D + 2 * rows


def rope_qk(tokens: int, H: int, Kv: int, hd: int, es: int,
            pos_es: int, positions: int) -> Tuple[int, int]:
    """q (tokens, H, hd) and k (tokens, Kv, hd) read and written at ``es``
    bytes an element, ``positions`` positions of ``pos_es`` bytes and the
    f32 frequencies (hd / 2,) read once; an angle a token and frequency,
    and four products and two sums a rotated pair (the sines and cosines
    are not counted)."""
    half = hd // 2
    return (es * 2 * tokens * (H + Kv) * hd + pos_es * positions + 4 * half,
            tokens * half + 6 * tokens * (H + Kv) * half)


def silu_mul(n: int, es: int) -> Tuple[int, int]:
    """g and u read and out written, ``n`` elements each at ``es`` bytes;
    a negation, an exp, a sum, a division and a product an element."""
    return 3 * es * n, 5 * n


def ssm_conv_step(rows: int, C: int, K: int, es: int,
                  param_es: int) -> Tuple[int, int]:
    """One token's depthwise causal conv: x (rows, C) read and y (rows, C)
    written at ``es`` bytes an element, the cache (rows, K - 1, C) read
    and written back shifted, the taps (K, C) and the bias (C,) read at
    ``param_es``; a product and a sum a tap, the bias, and SiLU's
    negation, exp, sum and division an element."""
    return (es * (2 * rows * C + 2 * rows * (K - 1) * C)
            + param_es * (K + 1) * C, (2 * K + 5) * rows * C)


def ssd_step(rows: int, nh: int, hd: int, ng: int, ds: int, es: int,
             param_es: int) -> Tuple[int, int]:
    """One token's SSD state update and gated output: the f32 state
    (rows, nh, hd, ds) read and written; x, z and the output g (rows,
    nh, hd), B and C (rows, ng, ds) and dt (rows, nh) at ``es`` bytes an
    element; dt_bias, A_log and D (nh,) at ``param_es``. A decay, an
    input product, a sum, a product with C and its sum a state element;
    x * dt, x * D, their sum, SiLU's four and the gate's product a row of
    the state; softplus (five), A's exp and negation, dt * A and its exp
    a head."""
    return (4 * 2 * rows * nh * hd * ds
            + es * (3 * rows * nh * hd + 2 * rows * ng * ds + rows * nh)
            + param_es * 3 * nh,
            5 * rows * nh * hd * ds + 8 * rows * nh * hd + 9 * rows * nh)
