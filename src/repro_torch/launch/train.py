"""Training launcher.

Counterpart of ``repro.launch.train``. The default mode trains the
REDUCED variant of ``--arch`` on the synthetic pipeline
(:class:`~repro_torch.training.data.SyntheticLM`) with the reference's
flags, on ``--device`` (``cuda`` by default; without a CUDA device,
``--device cpu``), and saves the params and optimizer state with
:func:`~repro_torch.training.checkpoint.save_checkpoint` when given
``--checkpoint`` (the reference's npz layout). ``--dry`` runs the full
config's train step (train_4k) on the production mesh on the meta device
(:mod:`repro_torch.launch.dryrun`) instead, and prints the reference's
"dry ... OK" line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \
        --steps 50 --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, train
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLM


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fmt", default="float32")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on (default cuda)")
    ap.add_argument("--dry", action="store_true",
                    help="run the FULL config's train step on the "
                         "production mesh, on the meta device, instead of "
                         "training")
    args = ap.parse_args(argv)

    if args.dry:
        from repro_torch.launch import dryrun
        dryrun.run_one(args.arch, "train_4k", multi_pod=False,
                       fmt="bfloat16", force=True, save=False)
        print("dry train_step lower+compile OK")
        return

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, fmt=args.fmt, device=args.device)
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.family}) on {model.device}")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  batch_size=args.batch))
    state = train(model, data.batches(), n_steps=args.steps,
                  log_every=max(args.steps // 10, 1),
                  opt_cfg=AdamWConfig(lr=args.lr,
                                      warmup_steps=args.steps // 10 + 1),
                  torch_device=args.device)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state.params, state.opt_state,
                        state.step)
        print(f"saved {args.checkpoint}")


if __name__ == "__main__":
    main()
