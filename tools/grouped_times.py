#!/usr/bin/env python3
"""Time the grouped dequant-matmul kernels of a tree of the PyTorch/CUDA
port at the MoE serve cells' expert shapes, on one NVIDIA GPU.

    python3 tools/grouped_times.py [--src DIR] [--fmt int8 nf4] [--reps 10]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), so that one call can time two commits
in turns, each from its own ``git archive``. At ``chip_smoke.py``'s
``GROUPED_SHAPES`` (qwen3-moe-30b-a3b's two expert products at decode, C
= 8, and prefill, C = 40; granite-moe-1b-a400m's at C = 8 and 160), with
the weights and x of ``torch.Generator(device="cuda").manual_seed(4)``,
it prints one JSON line a format and shape: (a) the kernel's time with
every row kept (random x, no counts), and (b) its time on the kept rows
of a seeded top-8 routing of the cell's tokens through this checkout's
dispatch (``chip_smoke.dispatch_rows``; x zero past the counts), given
the counts where the tree's grouped wrappers take them (``rows``) and
without them where not, each beside its bound (every row of every
expert; and the kept rows of the active experts, with the whole output
written: ``chip_smoke.kept_rows_cost``) and the largest relative error
against the tree's plain version. The first line holds the card's name
and power limit. Exits non-zero when no CUDA device is visible or a
kernel disagrees with its plain version by more than chip_smoke's
``KERNEL_REL_TOL``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--fmt", nargs="+", default=["int8", "nf4"])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs   # the shapes and helpers; puts ROOT/src on
    import torch              # the path
    if not torch.cuda.is_available():
        print("grouped_times: no CUDA device visible", file=sys.stderr)
        return 2
    # the routing comes from this checkout's dispatch; the kernels from
    # the tree under --src
    rows_of = {(E, C, T): None for _, E, C, T, _, _ in cs.GROUPED_SHAPES}
    for key in rows_of:
        rows_of[key] = cs.dispatch_rows(torch, *key, seed=key[0] + key[1])
    for mod in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[mod]
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import cost
    from repro_torch.kernels.quant_matmul import kernel as K
    if not Path(K.__file__).resolve().is_relative_to(
            Path(args.src).resolve()):
        raise SystemExit(f"grouped_times: imported {K.__file__}, not the "
                         f"tree under {args.src}")
    print(json.dumps({"card": cs.card_line(), "src": args.src}), flush=True)
    K.build()
    bf16 = torch.bfloat16
    takes_rows = "rows" in inspect.signature(K.int8_matmul_grouped).parameters
    gen = torch.Generator(device="cuda").manual_seed(4)
    rc = 0
    for arch, E, C, T, Kd, N in cs.GROUPED_SHAPES:
        w = torch.randn((E, Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        x = torch.randn((E, C, Kd), generator=gen, device="cuda").to(bf16)
        rows = rows_of[(E, C, T)]
        xb = x * (torch.arange(C, device="cuda")
                  < rows[:, None])[..., None].to(bf16)
        active = int((rows > 0).sum())
        for fmt in args.fmt:
            name = f"{fmt}_matmul"
            wargs, wbytes, _ = cs._quantized(torch, name, w, bf16)
            kern = getattr(K, name + "_grouped")
            plain = getattr(K, name + "_plain")
            wsets = [wargs] + [tuple(t.clone() for t in wargs)
                               for _ in range(cs._copies(wbytes) - 1)]
            kw = {"rows": rows} if takes_rows else {}
            line = {"arch": arch, "name": name + "_grouped", "E": E, "C": C,
                    "K": Kd, "N": N, "tokens": T, "active_experts": active,
                    "with_rows": takes_rows}
            for case, xx, kwc in (("all", x, {}), ("dispatch", xb, kw)):
                got = kern(xx, *wargs, bf16, **kwc)
                ref = plain(xx, *wargs, bf16, **kwc)
                torch.cuda.synchronize()
                rel = ((got.float() - ref.float()).abs().max()
                       / ref.float().abs().max().clamp_min(1e-30)).item()
                ms = cs.timed_ms(torch, lambda *a: kern(xx, *a, bf16, **kwc),
                                 wsets, reps=args.reps)
                line[f"{case}_ms"] = ms
                line[f"{case}_rel_err"] = rel
                if not rel <= cs.KERNEL_REL_TOL:
                    rc = 1
            for case, (nbytes, flops) in (
                    ("all", cost.quant_matmul(C, Kd, N, wbytes, 2, E)),
                    ("active", cs.kept_rows_cost(cost, E, C, Kd, N,
                                                 wbytes * active // E,
                                                 int(rows.sum())))):
                line[f"bound_{case}_ms"] = cs._bound(nbytes, flops,
                                                     "bfloat16")[0]
            print(json.dumps(line), flush=True)
            del wargs, wsets
        del w, x, xb
        torch.cuda.empty_cache()
    return rc


if __name__ == "__main__":
    sys.exit(main())
