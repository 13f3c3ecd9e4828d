"""Serving launcher: random-weight greedy serving of a paper-zoo model or
one of the architectures of ``ARCH_IDS`` (all but the audio one, whose
prefill needs frames the serving path does not carry; vlm serves text
only).

Counterpart of ``repro.launch.serve``. The default (executed) mode
builds the model, draws its weights from a seeded ``torch.Generator`` on
the device, quantizing each layer under ``--fmt`` as it is drawn, and
serves ``--n`` requests (random prompts from ``--seed``) arriving in
``--pattern`` (``burst``: all at t=0; ``fixed``: every
``--interval-ms``; ``random``: gaps uniform in [0, 2 x interval];
``poisson``: at 1 / interval a second) through
:class:`~repro_torch.serving.engine.ServeEngine`, and prints the host
wall time beside the analytic report's ``summary()`` (clock and energy
of the H100 SXM energy model), as the JAX launcher prints its summary.
``--sim`` serves the full-width config on the analytic backend alone (no
weights, no device): the paper's request distribution
(:func:`~repro_torch.serving.arrival.paper_requests`) in the pattern.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --full --fmt int8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --full --fmt nf4
    PYTHONPATH=src python -m repro_torch.launch.serve --sim \
        --pattern fixed --interval-ms 50 --n 500

Without ``--full`` the config is the reduced variant, as in the JAX
launcher. ``--dry`` waits for ROADMAP A7.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.batching.policy import SlotCountPolicy
from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config
from repro_torch.configs.paper_zoo import PAPER_MODELS
from repro_torch.models.api import Model, build_model
from repro_torch.serving.arrival import (fixed_arrivals, paper_requests,
                                         poisson_arrivals,
                                         uniform_random_arrivals)
from repro_torch.serving.backend import ExecutedBackend
from repro_torch.serving.engine import ServeEngine, ServeReport
from repro_torch.serving.requests import Request


@dataclasses.dataclass
class ServeResult:
    requests: List[Request]
    engine: ServeEngine
    model: Model
    params: Dict[str, Any]
    wall_s: float               # host wall time of engine.run
    report: ServeReport         # the analytic clock and energy of the run


def make_requests(vocab_size: int, n: int, seed: int,
                  prompt_len: Tuple[int, int] = (8, 24),
                  new_tokens: Tuple[int, int] = (4, 12),
                  arrivals: Optional[Sequence[float]] = None
                  ) -> List[Request]:
    """``n`` requests with prompt lengths and output lengths drawn
    uniformly from the inclusive ranges, tokens uniform over the
    vocabulary, arriving at ``arrivals`` (all at t=0 by default)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        reqs.append(Request(
            req_id=i,
            prompt=rng.integers(0, vocab_size, plen).astype(np.int64),
            prompt_len=plen,
            max_new_tokens=int(rng.integers(new_tokens[0],
                                            new_tokens[1] + 1)),
            arrival_time=0.0 if arrivals is None else float(arrivals[i])))
    return reqs


PATTERNS = ("burst", "fixed", "random", "poisson")


def pattern_arrivals(pattern: str, n: int, interval_s: float
                     ) -> List[float]:
    """The reference launcher's arrival patterns: ``burst`` (all at
    t=0), ``fixed`` (every ``interval_s``), ``random`` (gaps uniform in
    [0, 2 x interval_s]) and ``poisson`` (at 1 / interval_s a
    second)."""
    if pattern == "burst":
        return [0.0] * n
    if pattern == "fixed":
        return fixed_arrivals(n, interval_s)
    if pattern == "random":
        return uniform_random_arrivals(n, 0.0, 2 * interval_s)
    if pattern == "poisson":
        return poisson_arrivals(n, 1.0 / max(interval_s, 1e-6))
    raise ValueError(f"unknown pattern {pattern!r}; known: {PATTERNS}")


def arch_config(arch: str) -> ModelConfig:
    """The config of a paper-zoo model or of an ``ARCH_IDS`` id."""
    if arch in PAPER_MODELS:
        return PAPER_MODELS[arch]
    return get_config(arch)


def build_params(model: Model, seed: int) -> Dict[str, Any]:
    """Random master weights from ``seed`` on the model's device, under
    post-training quantization in the model's format: each layer is
    quantized as soon as it is drawn, so the 16-bit masters of the whole
    stack are never resident together (the bytes of drawing everything,
    then quantizing)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model.init(gen, quantize=True)


def serve(arch: str = "llama-3.1-8b", fmt: str = "bfloat16", n: int = 24,
          max_batch: int = 8, mode: str = "continuous",
          kv_quant: bool = False, device="cuda", seed: int = 0,
          reduced: bool = True, *, max_prefill_batch: int = 8,
          buf_len: int = 64, prompt_len: Tuple[int, int] = (8, 24),
          new_tokens: Tuple[int, int] = (4, 12),
          record_logits: bool = False,
          model: Optional[Model] = None,
          params: Optional[Dict[str, Any]] = None,
          arrivals: Optional[Sequence[float]] = None) -> ServeResult:
    """Serve ``n`` random requests on ``arch`` under ``fmt``, arriving at
    ``arrivals`` (all at t=0 by default), priced for the served config.

    Pass ``model`` and ``params`` from an earlier result to serve again
    on the same weights (for example the same requests in the other
    mode); otherwise they are built from ``seed``."""
    if model is None:
        cfg = arch_config(arch)
        model = build_model(cfg.reduced() if reduced else cfg, fmt=fmt,
                            kv_quant=kv_quant, device=device)
        params = build_params(model, seed)
    elif params is None:
        raise ValueError("model= needs params=")
    reqs = make_requests(model.cfg.vocab_size, n, seed, prompt_len,
                         new_tokens, arrivals)
    backend = ExecutedBackend(model.cfg, model, params, max_batch=max_batch,
                              buf_len=buf_len, record_logits=record_logits)
    eng = ServeEngine(model.cfg, mode=mode, backend=backend,
                      batch_policy=SlotCountPolicy(
                          max_batch=max_batch,
                          max_prefill_batch=max_prefill_batch))
    t0 = time.perf_counter()
    report = eng.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return ServeResult(requests=reqs, engine=eng, model=model,
                       params=params, wall_s=time.perf_counter() - t0,
                       report=report)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-3.1-8b",
                    choices=sorted(PAPER_MODELS) + list(ARCH_IDS))
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--pattern", default="burst", choices=PATTERNS)
    ap.add_argument("--interval-ms", type=float, default=20.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--fmt", default="bfloat16")
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "sequential"])
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width config (on the card)")
    ap.add_argument("--sim", action="store_true",
                    help="the analytic backend alone at full width: no "
                         "weights, no device")
    args = ap.parse_args()
    arrivals = pattern_arrivals(args.pattern, args.n,
                                args.interval_ms / 1e3)

    if args.sim:
        cfg = arch_config(args.arch)
        reqs = paper_requests(args.n, arrivals, seed=args.seed)
        rep = ServeEngine(cfg, fmt=args.fmt, mode=args.mode,
                          batch_policy=SlotCountPolicy(
                              max_batch=args.max_batch)).run(reqs)
        print(f"model                  {cfg.name} (analytic, h100-sxm "
              f"energy model)")
        for k, v in rep.summary().items():
            print(f"{k:22s} {v:.6g}")
        return

    res = serve(args.arch, args.fmt, n=args.n, max_batch=args.max_batch,
                mode=args.mode, kv_quant=args.kv_quant, device=args.device,
                seed=args.seed, reduced=not args.full,
                buf_len=512 if args.full else 64, arrivals=arrivals)
    tokens = sum(len(r.generated) for r in res.requests)
    phases = res.engine.backend.phases
    pre = [p.wall_s for p in phases
           if p.phase == "prefill" and p.wall_s is not None]
    dec = [p.wall_s for p in phases
           if p.phase == "decode" and p.wall_s is not None]
    print(f"model                  {res.model.cfg.name}")
    print(f"format                 {args.fmt}")
    print(f"device                 {res.model.device}")
    print(f"requests               {len(res.requests)}")
    print(f"generated_tokens       {tokens}")
    print(f"wall_s                 {res.wall_s:.6g}")
    print(f"tokens_per_s           {tokens / res.wall_s:.6g}")
    if pre:
        print(f"prefill_phases         {len(pre)}")
        print(f"mean_prefill_ms        {1e3 * np.mean(pre):.6g}")
    if dec:
        print(f"decode_steps           {len(dec)}")
        print(f"mean_decode_step_ms    {1e3 * np.mean(dec):.6g}")
    rep = res.report
    print("analytic (h100-sxm energy model)")
    for k, v in rep.summary().items():
        print(f"  {k:<21}{v:.6g}")
    print(f"  {'total_energy_j':<21}{rep.total_energy_j:.6g}")
    print(f"  {'wall_time_s':<21}{rep.wall_time_s:.6g}")
    print(f"  {'energy_per_token_j':<21}"
          f"{3600.0 * rep.mean_energy_per_token_wh:.6g}")


if __name__ == "__main__":
    main()
