"""Carbon-aware geo-routing demo: one diurnal arrival stream served
from two regions whose grid carbon intensity swings in exact
anti-phase (think us-west + eu-central, 12 h apart). The carbon-aware
router chases the cleaner grid around the planet — same fleet, same
requests, lower gCO2/request than round-robin — while the price-aware
variant chases the cheaper one.

All routers here are the ``*_gated`` variants (idle replicas may
power-gate under any of them), so the gCO2 gap is pure routing
quality, not an idle-power discount.

    PYTHONPATH=src python examples/torch/fleet_carbon.py
"""
import repro_torch
from repro_torch.fleet import sinusoid_region

# compressed "day": the carbon/price sinusoids and the diurnal arrival
# wave share this period, so the run sees both grids clean and dirty
PERIOD_S = 1200.0
RATE_PER_S = 4.0
N_REQ = int(RATE_PER_S * PERIOD_S)

# two 2-replica slices; phase_h = PERIOD_S/7200 puts the second
# region's carbon trough exactly on the first one's crest
REGIONS = [sinusoid_region("us-west", carbon_mean=350.0,
                           carbon_amp=300.0, phase_h=0.0,
                           period_s=PERIOD_S, replicas=2,
                           price_mean=0.12, price_amp=0.05),
           sinusoid_region("eu-central", carbon_mean=350.0,
                           carbon_amp=300.0,
                           phase_h=PERIOD_S / 7200.0,
                           period_s=PERIOD_S, replicas=2,
                           price_mean=0.10, price_amp=0.05)]

BASE = repro_torch.ExperimentSpec(
    model="llama-3.1-8b", mode="continuous", max_batch=16,
    replicas=4, n_requests=N_REQ, regions=REGIONS,
    arrival="diurnal",
    arrival_params={"base_rate_per_s": RATE_PER_S, "period_s": PERIOD_S,
                    "amp_frac": 0.6})

ROUTERS = ["round_robin_gated", "least_loaded_gated",
           "carbon_aware_gated", "price_aware_gated"]


def main() -> None:
    print(f"fleet: 2 regions x 2 {BASE.model} replicas, {N_REQ} "
          "diurnal requests; carbon sinusoids in anti-phase\n")
    print(f"{'router':20s} {'gCO2/req':>9s} {'$/req':>10s} "
          f"{'Wh/req':>8s} {'client p99':>10s}")
    grid = repro_torch.sweep(BASE, {"router": ROUTERS})
    for label, r in grid.results.items():
        router = label.split("=", 1)[1]
        print(f"{router:20s} {r.gco2_per_request_g:9.4f} "
              f"{r.usd_per_request:10.6f} {r.mean_energy_wh:8.5f} "
              f"{r.client_latency_p99_s:9.2f}s")
    base = grid.results["router=round_robin_gated"]
    carbon = grid.results["router=carbon_aware_gated"]
    price = grid.results["router=price_aware_gated"]
    print(f"\ncarbon-aware routing cuts gCO2/request "
          f"{base.gco2_per_request_g / carbon.gco2_per_request_g:.2f}x "
          f"vs round-robin at "
          f"{carbon.client_latency_p99_s / base.client_latency_p99_s:.2f}x "
          "the client p99; price-aware cuts $/request "
          f"{base.usd_per_request / price.usd_per_request:.2f}x — "
          "energy moves to the clean (or cheap) grid, carbon falls.")


if __name__ == "__main__":
    main()
