"""Energy of failure: spot preemption, served three ways.

A 2-replica fleet takes a spot-style preemption on replica 0 — the
provider gives an 8 s notice, then the replica is dark for 20 s. The
same workload and schedule run under three resilience policies:

* **no retry** — in-flight work dies with the replica, terminally
  failed; every joule it had billed is waste.
* **retry, hard kill** — killed work re-enters the queue after
  exponential backoff and fails over to the healthy replica, but the
  notice is ignored: the joules spent before the kill are still
  burned twice.
* **retry + graceful drain** — on the notice the replica stops
  admitting, its queue re-routes immediately, and in-flight requests
  finish inside the notice window; nothing is killed, nothing is
  wasted.

Prints completion, wasted joules, and Wh per completed request for
each policy — the drain column is the point of the exercise: surviving
preemption costs energy only when you ignore the warning.

Runs in a few host seconds:

    PYTHONPATH=src python examples/torch/resilience_drain.py
"""
import repro_torch

FAULTS = ({"t": 2.0, "kind": "preempt", "replica": 0,
           "notice_s": 8.0, "downtime_s": 20.0},)

SPEC = repro_torch.ExperimentSpec(
    model="llama-3.1-8b", max_batch=32, n_requests=160,
    replicas=2, arrival="poisson",
    arrival_params={"rate_per_s": 6.0, "seed": 1},
    prompt_range=(200, 4000), output_range=(10, 300))

POLICIES = (
    ("no retry", dict(faults=FAULTS)),
    ("retry, hard kill", dict(faults=FAULTS, retry="backoff",
                              retry_params={"drain_on_notice": False})),
    ("retry + drain", dict(faults=FAULTS, retry="backoff")),
)


def main() -> None:
    n = SPEC.n_requests  # the test harness shrinks this for smoke runs
    print(f"spot preemption on replica 0 of {SPEC.replicas} "
          f"(8s notice, 20s downtime), {n} requests @ "
          f"{SPEC.arrival_params['rate_per_s']:.0f}/s\n")
    print(f"{'policy':18s} {'done':>9s} {'failed':>7s} "
          f"{'wasted J':>9s} {'Wh/done':>9s} {'avail':>7s}")

    for name, kw in POLICIES:
        r = SPEC.derive(**kw).run()
        print(f"{name:18s} {r.n_completed:4d}/{n:<4d} "
              f"{r.n_failed:7d} {r.wasted_energy_j:9.1f} "
              f"{r.goodput_wh_per_request:9.5f} {r.availability:7.4f}")

    print("\nthe drain row is the headline: with the notice honoured, "
          "the fleet\ncompletes everything and wastes next to nothing "
          "— hard kill pays for\nthe same work twice.")


if __name__ == "__main__":
    main()
