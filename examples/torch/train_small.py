"""Train a small LM for a few hundred steps on the synthetic pipeline
(the training-substrate driver; the serving driver is
examples/torch/serve_batched.py).

    PYTHONPATH=src python examples/torch/train_small.py [--steps 200] \
        [--device cpu]

The model trains on ``--device`` (``cuda`` by default); the checkpoint,
in the reference's npz layout, goes to ``--out``.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training import train, AdamWConfig
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import SyntheticLM, DataConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--out", default="build/train_small_ck.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on (default cuda)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, fmt="float32", device=args.device)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.family}) on {model.device}")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  batch_size=8))
    state = train(model, data.batches(), n_steps=args.steps,
                  log_every=20,
                  opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=20),
                  torch_device=args.device)
    save_checkpoint(args.out, state.params, state.opt_state, state.step)
    print(f"checkpoint saved to {args.out}")


if __name__ == "__main__":
    main()
