"""Energy per *task*, not per request: serve dependent-request
workflows (agent loops, RAG chains, best-of-N fan-out, speculative
decoding) through the continuous-batching engine and compare what a
unit of user-visible work actually costs — including the KV prefix
reuse that makes multi-round agent loops affordable.

    PYTHONPATH=src python examples/torch/workflow_energy.py
"""
import repro_torch

N_TASKS = 12

BASE = repro_torch.ExperimentSpec(
    model="llama-3.1-8b", fmt="bfloat16", mode="continuous",
    max_batch=16, n_requests=N_TASKS,
    arrival="poisson", arrival_params={"rate_per_s": 2.0})


def main() -> None:
    print(f"serving {N_TASKS} tasks of each workflow template on "
          f"{BASE.model} (Poisson arrivals, continuous batching)\n")
    print(f"{'workflow':12s} {'steps':>5s} {'Wh/task':>8s} "
          f"{'Wh/tok':>9s} {'crit path':>9s} {'p99 lat':>8s} "
          f"{'KV reused':>9s}")
    for name in repro_torch.WORKFLOW_TEMPLATES:
        r = BASE.derive(workflow=name).run()
        steps = sum(t.n_steps for t in r.report.tasks) // r.n_tasks
        print(f"{name:12s} {steps:5d} {r.mean_energy_per_task_wh:8.5f} "
              f"{r.mean_energy_per_token_wh:9.6f} "
              f"{r.mean_task_critical_path_s:8.2f}s "
              f"{r.latency_p99_s:7.2f}s {r.prefix_reused_tokens:9d}")

    # the agent-loop ablation: what does prefix reuse actually buy?
    loop = BASE.derive(workflow="agent_loop",
                       workflow_params={"rounds": 6})
    with_reuse = loop.run()
    without = loop.derive(workflow_reuse=False).run()
    save = (without.mean_energy_per_task_wh
            / with_reuse.mean_energy_per_task_wh)
    print(f"\nagent_loop (6 rounds), KV prefix reuse on vs off:")
    print(f"  reuse on : {with_reuse.mean_energy_per_task_wh:.5f} "
          f"Wh/task ({with_reuse.prefix_reused_tokens} prompt tokens "
          f"forked, not re-prefilled)")
    print(f"  reuse off: {without.mean_energy_per_task_wh:.5f} Wh/task")
    print(f"  -> {save:.2f}x less energy per task: each round's prompt "
          "extends the previous context, so re-prefilling it is pure "
          "waste — the forked KV pages make the dominant prefill term "
          "nearly free.")


if __name__ == "__main__":
    main()
