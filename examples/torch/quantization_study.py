"""Paper §3 in miniature: post-training-quantize a real model and
compare (a) numerical drift of the logits, (b) modeled phase energy —
including the fused-dequant path of the port's hand-written int8/nf4
kernels.

    PYTHONPATH=src python examples/torch/quantization_study.py [--device cpu]

The models run on ``--device`` (``cuda`` by default).
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import PhaseProfiler, make_policy
from repro_torch.core.energy import FusedDequantEnergyModel
from repro_torch.core.hardware import H100_SXM
from repro_torch.launch.serve import build_params
from repro_torch.models import build_model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the models run on (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config("minitron-8b").reduced()
    m32 = build_model(cfg, fmt="float32", device=args.device)
    params = build_params(m32, seed=0)
    gen = torch.Generator(device=m32.device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                         device=m32.device)
    ref, _ = m32.prefill(params, {"tokens": toks})
    print(f"{cfg.name}: logits drift after PTQ (real computation)")
    for fmt in ("bfloat16", "int8", "nf4"):
        mq = build_model(cfg, fmt=fmt, device=args.device)
        qp = mq.quantize(params)
        lq, _ = mq.prefill(qp, {"tokens": toks})
        rel = float(torch.linalg.norm(lq - ref) / torch.linalg.norm(ref))
        same = float((torch.argmax(lq, -1)
                      == torch.argmax(ref, -1)).float().mean())
        print(f"  {fmt:9s} rel_err={rel:.4f}  argmax_match={same:.2f}")

    full = get_config("minitron-8b")
    print("\nmodeled decode energy/token, 8B class (paper Fig 1b):")
    for fmt in ("float32", "bfloat16", "int8", "nf4"):
        prof = PhaseProfiler(full, H100_SXM, make_policy(fmt))
        e = prof.profile_decode_step(1, 1200).energy_j
        print(f"  H100 eager {fmt:9s} {e:6.2f} J/token")
    for fmt in ("bfloat16", "int8", "nf4"):
        prof = PhaseProfiler(full, H100_SXM, make_policy(fmt),
                             energy_model_cls=FusedDequantEnergyModel,
                             stack="fused")
        e = prof.profile_decode_step(1, 1200).energy_j
        print(f"  H100 fused {fmt:9s} {e:6.3f} J/token  "
              f"(dequant inside the matmul kernel)")
    print("\nthe eager path reproduces the paper's int8 decode penalty; "
          "the fused kernels remove it (weights stream at half the "
          "bytes, no extra launches).")


if __name__ == "__main__":
    main()
