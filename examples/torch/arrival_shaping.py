"""Paper §5 in miniature: how request arrival shaping changes energy per
request for LLaMA-3.1-8B under TGI-style continuous batching — as a
declarative sweep over `repro_torch.ExperimentSpec`.

    PYTHONPATH=src python examples/torch/arrival_shaping.py
"""
import repro_torch

BASE = repro_torch.ExperimentSpec(model="llama-3.1-8b", fmt="bfloat16",
                                  mode="continuous", max_batch=64,
                                  n_requests=300)


def main() -> None:
    naive, _ = repro_torch.run_spec(BASE.derive(mode="sequential"))
    grid = repro_torch.sweep(BASE, {"pattern": [
        repro_torch.Option("burst (all at t=0)"),
        repro_torch.Option("random U(0,100ms)", arrival="uniform",
                           arrival_params={"low_s": 0.0, "high_s": 0.1}),
        repro_torch.Option("fixed 50ms", arrival="fixed",
                           arrival_params={"interval_s": 0.05}),
        repro_torch.Option("fixed 20ms", arrival="fixed",
                           arrival_params={"interval_s": 0.02}),
        repro_torch.Option("fixed 10ms", arrival="fixed",
                           arrival_params={"interval_s": 0.01}),
    ]})

    base = naive.mean_energy_wh
    print(f"{'pattern':24s} {'Wh/request':>12s} {'mean batch':>11s} "
          f"{'vs naive':>9s}")
    print(f"{'naive sequential':24s} {base:12.5f} {1.0:11.1f} "
          f"{1.0:8.1f}x")
    for label, r in grid.results.items():
        print(f"{label:24s} {r.mean_energy_wh:12.5f} "
              f"{r.mean_batch:11.1f} {base / r.mean_energy_wh:8.1f}x")
    print("\nsteady spacing at a rate the server can batch -> biggest "
          "win (paper: up to 100x vs the naive baseline)")


if __name__ == "__main__":
    main()
