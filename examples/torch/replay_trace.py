"""Record a serving run's phase stream, then replay it — the
InferenceBackend protocol end to end.

The serving engines are backend-agnostic event loops: the scheduler
(queueing, continuous batching, KV paging) stays live while the *cost
source* is swapped. This demo:

1. serves a bursty workload on the analytic backend, recording every
   phase (`RecordingBackend`) into the `repro-replay/v1` JSON format,
2. replays that trace (`ReplayBackend`) through the same scheduler and
   checks the report reproduces,
3. replays the shipped H100 trace fixture via the declarative spec axis
   (`backend="replay"`, `replay_path=...`) — exactly how a real
   NVML-sampled phase sweep would drive the simulator.

    PYTHONPATH=src python examples/torch/replay_trace.py
"""
import os
import tempfile

import repro_torch
from repro_torch.serving import (AnalyticBackend, RecordingBackend,
                                 ReplayBackend, ServeEngine)
from repro_torch.batching.policy import SlotCountPolicy

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "..", "tests",
                       "data", "replay_h100_small.json")

SPEC = repro_torch.ExperimentSpec(
    model="llama-3.1-8b", fmt="bfloat16", mode="continuous",
    max_batch=16, n_requests=64, arrival="burst",
    arrival_params={"burst_size": 16, "burst_gap_s": 4.0})


def main() -> None:
    cfg = SPEC.model_config()

    # 1. record: analytic backend wrapped in a recorder
    rec = RecordingBackend(AnalyticBackend(cfg))
    eng = ServeEngine(cfg, backend=rec, batch_policy=SlotCountPolicy(
        max_batch=SPEC.max_batch))
    ref = eng.run(SPEC.requests())
    path = os.path.join(tempfile.gettempdir(), "replay_demo_trace.json")
    trace = rec.dump(path, device="h100-sxm", model=cfg.name,
                     source="examples/torch/replay_trace.py")
    print(f"recorded {len(trace['prefill'])} prefill + "
          f"{len(trace['decode'])} decode operating points -> {path}")
    print(f"  analytic reference: "
          f"{ref.mean_energy_per_request_wh*1e3:.3f} mWh/request, "
          f"{ref.wall_time_s:.1f}s wall")

    # 2. replay the recording through the same live scheduler
    rep = ServeEngine(cfg,
                      backend=ReplayBackend.from_json(path),
                      batch_policy=SlotCountPolicy(
                          max_batch=SPEC.max_batch)).run(SPEC.requests())
    drift = rep.total_energy_j / ref.total_energy_j
    print(f"  replayed:           "
          f"{rep.mean_energy_per_request_wh*1e3:.3f} mWh/request "
          f"(round-trip drift {drift:.4f}x)")
    assert 0.95 < drift < 1.05, \
        f"replay round trip drifted {drift:.3f}x from the recording"

    # 3. the declarative axis: a shipped H100 trace drives the spec
    res = SPEC.derive(backend="replay", replay_path=FIXTURE).run()
    print(f"fixture replay via ExperimentSpec(backend='replay'): "
          f"{res.mean_energy_wh*1e3:.3f} mWh/request "
          f"[spec {res.spec_hash}]")

    # the scheduler under replay still batches/schedules for real
    print(f"  mean live decode batch under replay: {res.mean_batch:.1f}")


if __name__ == "__main__":
    main()
