#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the script with a
non-zero exit code:

1. card: the GPU's name and power limit (``nvidia-smi``); TF32 off.
2. build: both dequant-matmul kernels from ``src/repro_torch/kernels/
   quant_matmul/csrc``, timed.
3. kernels: each kernel against its plain PyTorch version at the
   llama-3.1-8b projection shapes (M in {1, 4, 8, 512}, four (K, N)) in
   bf16, with the kernel, plain and library times and the card's bound.
4. serve: llama-3.1-8b at full width (random weights from
   ``torch.Generator(device="cuda").manual_seed(0)``) under each of the
   five formats: a continuous run of 8 requests through
   ``repro_torch.launch.serve.serve``, the launch counts of the kernels
   in that run, and each request's prefill logits against its own
   sequential run.

The line before the last holds the card's name and power limit, the one
before it the ``kernels`` summary, and the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
no CUDA device is visible.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense): HBM3 bytes/s and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2**20

SHAPES_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# 1: a sequential decode step; 4: the serve phase's decode batch
# (max_batch); 8: the widest decode tile; 512: a prefill of two prompts
SHAPES_M = [1, 4, 8, 512]
HEADLINE = (4, 4096, 14336)     # the serve phase's decode, w_gate
# kernel vs plain, bf16 output: both round one f32 sum to bf16 (2^-8
# relative), after summing K products in different orders
KERNEL_REL_TOL = 1e-2
FORMATS = ("float32", "float16", "bfloat16", "int8", "nf4")
# batched prefill vs the request's own prefill: the same arithmetic at
# other M and padding, so only the order of f32 sums differs; through 32
# layers that moves f32 logits by ~1e-6 of their range and 16-bit
# activations by a few bf16 ulps
PREFILL_LOGIT_TOL = {"float32": 1e-3, "float16": 5e-2, "bfloat16": 5e-2,
                     "int8": 5e-2, "nf4": 5e-2}
REPLACES = {
    "int8_matmul": "src/repro/kernels/quant_matmul/kernel.py:55",
    "nf4_matmul": "src/repro/kernels/quant_matmul/kernel.py:112",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, arg_sets, reps: int = 10,
             graph: bool = True) -> float:
    """Device time of ``fn`` per call, over 3 * ``reps`` calls cycling
    through ``arg_sets`` (so that consecutive calls read different
    weights), between CUDA events. With ``graph`` the calls are captured
    in a CUDA graph and replayed, which takes the host's launch cost out
    of the reading; the plain versions copy the codebook from the host,
    which a capture refuses, and are timed from eager launches."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(3):
        if graph:
            g.replay()
        else:
            for i in range(reps):
                fn(*arg_sets[(r * reps + i) % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def kernel_phase(torch, K):
    from repro_torch.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.quant.nf4 import dequantize_nf4, quantize_nf4
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"int8_matmul": [], "nf4_matmul": []}
    for (Kd, N) in SHAPES_KN:
        w = torch.randn((Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        q8 = quantize_int8(w, 0.01)
        q4 = quantize_nf4(w, 64)
        del w
        weights = {
            "int8_matmul": ((q8.codes, q8.scale), Kd * N + 4 * N,
                            dequantize_int8(q8, bf16)),
            "nf4_matmul": ((q4.packed, q4.absmax),
                           Kd * N // 2 + 4 * (Kd // 64) * N,
                           dequantize_nf4(q4, bf16)),
        }
        for name, (wargs, wbytes, wdeq) in weights.items():
            kern = getattr(K, name)
            plain = getattr(K, name + "_plain")
            copies = max(1, min(32, math.ceil(2 * L2_BYTES / wbytes)))
            wsets = [wargs] + [tuple(t.clone() for t in wargs)
                               for _ in range(copies - 1)]
            lcopies = max(1, min(32, math.ceil(2 * L2_BYTES / (2 * Kd * N))))
            lsets = [wdeq] + [wdeq.clone() for _ in range(lcopies - 1)]
            for M in SHAPES_M:
                x = torch.randn((M, Kd), generator=gen, device="cuda").to(bf16)
                got = kern(x, *wargs, bf16)
                ref = plain(x, *wargs, bf16)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs().max().item()
                rel = diff / max(ref.float().abs().max().item(), 1e-30)
                k_ms = timed_ms(torch, lambda *a: kern(x, *a, bf16),
                                wsets)
                p_ms = timed_ms(torch, lambda *a: plain(x, *a, bf16),
                                [wargs], reps=3, graph=False)
                l_ms = timed_ms(torch, lambda w_: torch.matmul(x, w_),
                                [(t,) for t in lsets])
                nbytes = 2 * M * Kd + wbytes + 2 * M * N
                flops = 2 * M * Kd * N
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / BF16_FLOP_PER_S * 1e3
                row = {"phase": "kernel", "name": name, "M": M, "K": Kd,
                       "N": N, "max_abs_err": diff, "max_rel_err": rel,
                       "rel_tol": KERNEL_REL_TOL, "kernel_ms": k_ms,
                       "plain_ms": p_ms, "library_ms": l_ms,
                       "bytes": nbytes, "flops": flops,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations"}
                emit(row)
                if not rel <= KERNEL_REL_TOL:
                    raise SystemExit(f"{name} disagrees with its plain "
                                     f"version at M={M} K={Kd} N={N}: "
                                     f"rel {rel} > {KERNEL_REL_TOL}")
                rows[name].append(row)
            del wsets, lsets
        del weights, q8, q4
        torch.cuda.empty_cache()
    return rows


def serve_phase(torch, K, cfg):
    from repro_torch.launch.serve import build_params, serve
    from repro_torch.models.api import build_model
    kw = dict(n=8, max_batch=4, max_prefill_batch=2, buf_len=512,
              prompt_len=(64, 256), new_tokens=(32, 32), seed=0,
              record_logits=True)
    launches = {}
    for fmt in FORMATS:
        t0 = time.perf_counter()
        model = build_model(cfg, fmt=fmt, device="cuda")
        params = build_params(model, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        con = serve(model=model, params=params, mode="continuous", **kw)
        counts = dict(K.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches[fmt] = counts
        for r in con.requests:
            if len(r.generated) != r.max_new_tokens:
                raise SystemExit(f"{fmt}: request {r.req_id} got "
                                 f"{len(r.generated)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r.generated):
                raise SystemExit(f"{fmt}: token out of the vocabulary")
        for name, fmt_of in (("int8_matmul", "int8"),
                             ("nf4_matmul", "nf4")):
            if (counts[name] > 0) != (fmt == fmt_of):
                raise SystemExit(f"{fmt}: {name} launched "
                                 f"{counts[name]} times")
        seq = serve(model=model, params=params, mode="sequential", **kw)
        worst = 0.0
        for rc, rs in zip(con.requests, seq.requests):
            a = con.engine.backend.first_logits[rc.req_id]
            b = seq.engine.backend.first_logits[rs.req_id]
            if not torch.isfinite(a).all():
                raise SystemExit(f"{fmt}: non-finite prefill logits")
            worst = max(worst, ((a - b).abs().max()
                                / b.abs().max()).item())
        if not worst <= PREFILL_LOGIT_TOL[fmt]:
            raise SystemExit(f"{fmt}: batched prefill logits differ from "
                             f"the sequential run by {worst} > "
                             f"{PREFILL_LOGIT_TOL[fmt]}")
        same = sum(rc.generated == rs.generated
                   for rc, rs in zip(con.requests, seq.requests))
        tok_same = sum(x == y for rc, rs in zip(con.requests, seq.requests)
                       for x, y in zip(rc.generated, rs.generated))
        n_tok = sum(len(r.generated) for r in con.requests)
        pre = [p.latency_s for p in con.engine.phases
               if p.phase == "prefill"]
        dec = [p.latency_s for p in con.engine.phases
               if p.phase == "decode"]
        emit({"phase": "serve", "fmt": fmt, "model": cfg.name,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "requests": len(con.requests),
              "prompt_lens": [r.prompt_len for r in con.requests],
              "generated_tokens": n_tok, "init_s": init_s,
              "wall_s": con.wall_s, "tokens_per_s": n_tok / con.wall_s,
              "prefill_phases": len(pre),
              "prefill_ms_mean": 1e3 * sum(pre) / len(pre),
              "decode_steps": len(dec),
              "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
              "peak_mem_gb": peak_gb, "launches": counts,
              "prefill_logit_rel_err": worst,
              "prefill_logit_tol": PREFILL_LOGIT_TOL[fmt],
              "requests_same_tokens_as_sequential": same / len(con.requests),
              "tokens_same_as_sequential": tok_same / n_tok})
        del model, params, con, seq
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.quant_matmul import kernel as K

    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = K.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libs]})

    rows = kernel_phase(torch, K)
    from repro_torch.configs.paper_zoo import PAPER_MODELS
    launches = serve_phase(torch, K, PAPER_MODELS["llama-3.1-8b"])

    kernels = []
    for name in K.KERNELS:
        head = next(r for r in rows[name]
                    if (r["M"], r["K"], r["N"]) == HEADLINE)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/quant_matmul/csrc/"
                      f"{name}.cu",
            "replaces": REPLACES[name],
            "launches": max(c[name] for c in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "max_rel_err": max(r["max_rel_err"] for r in rows[name]),
            "shape": list(HEADLINE),
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "bytes": head["bytes"],
            "library_ms": head["library_ms"],
            "library_is": "torch.matmul on the weight already "
                          "dequantized to bf16 (does less work)",
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
