"""Multi-pod dry-run launcher.

Counterpart of ``repro.launch.dryrun``. For every (architecture x input
shape x mesh) combination it builds the step (train step, prefill or
decode step) with every parameter, optimizer moment, input and cache an
empty tensor on the ``meta`` device, placed as DTensors by the production
sharding rules (:mod:`repro_torch.launch.sharding`) on a 256- or
512-rank mesh over a fake process group (:mod:`repro_torch.launch.mesh`).
It runs the step once under an :class:`~repro_torch.core.op_analysis.
OpCounter`, inside :func:`~repro_torch.models.moe.expert_parallel` as
the reference does, and reads

* the memory of one device: the exact local bytes of the placed
  arguments and of the outputs, and the counter's peak of live
  intermediates for XLA's ``temp_size_in_bytes``; ``fits`` says whether
  arguments and intermediates fit the H100's HBM;
* dot FLOPs, bytes and collective bytes of rank 0's own program, which
  :func:`~repro_torch.core.roofline.terms_from_counts` multiplies by the
  chip count and prices on the H100 SXM.

Nothing is drawn and nothing is allocated: the hand-written kernels
report their costs from their ``meta`` branches. The reference's record
keys are kept (``raw_cost_analysis`` holds the same per-chip counts, as a
Python loop has no body counted once; ``lower_s`` is the time to build
and place the step, ``compile_s`` the time to run it under the counter).
Results are cached as JSON under ``experiments/dryrun_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch stablelm-1.6b --shape train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ModelConfig,
                                      ShapeConfig, get_config)
from repro_torch.configs.paper_zoo import PAPER_MODELS
from repro_torch.core import workload as W
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.op_analysis import analyze_step, tree_bytes
from repro_torch.core.roofline import terms_from_counts
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (data_axes, fake_mesh, n_chips,
                                     production_shape)
from repro_torch.models.api import Model, build_model

RESULTS_DIR = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
# the long-context SWA variant window for full-attention archs
LONG_CONTEXT_WINDOW = 8192


def arch_config(arch: str) -> ModelConfig:
    """The config of an ``ARCH_IDS`` id or of a paper-zoo model."""
    return PAPER_MODELS[arch] if arch in PAPER_MODELS else get_config(arch)


def make_model(arch: str, shape_name: str, fmt: str = "bfloat16",
               kv_quant: bool = False,
               cfg: Optional[ModelConfig] = None) -> Model:
    """The model of ``arch`` (or ``cfg``) on the meta device, with the
    documented sliding-window variant at long_500k for full-attention
    architectures."""
    cfg = cfg or arch_config(arch)
    window_override = None
    if shape_name == "long_500k" and not cfg.subquadratic:
        window_override = LONG_CONTEXT_WINDOW
    return build_model(cfg, fmt=fmt, window_override=window_override,
                       kv_quant=kv_quant, device="meta")


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    if shape.kind == "train":
        return W.model_flops_6nd(cfg, shape.global_batch * shape.seq_len,
                                 train=True)
    if shape.kind == "prefill":
        return W.model_flops_6nd(cfg, shape.global_batch * shape.seq_len)
    return W.model_flops_6nd(cfg, shape.global_batch)   # one decode step


def _decode_buf_len(model: Model, shape: ShapeConfig) -> int:
    if model.window is not None:
        return min(shape.seq_len, model.window)
    return shape.seq_len


def build_step(model: Model, shape: ShapeConfig, mesh):
    """Returns (fn, args, in_specs): the step, its arguments as DTensors
    on ``mesh`` (empty, on the meta device) and their spec trees."""
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import make_train_step
    cfg = model.cfg
    inputs = model.input_specs(shape)
    in_batch_specs = sh.input_specs_sharding(cfg, shape, mesh, inputs)
    batch = sh.place(mesh, inputs, in_batch_specs)
    params = model.abstract_params(quantize=model.policy.is_quantized)
    pspecs = sh.param_specs(params, mesh)
    placed = sh.place(mesh, params, pspecs)

    if shape.kind == "train":
        opt = adamw_init(params)
        ospecs = sh.opt_specs(opt, pspecs, mesh)
        step = make_train_step(model, remat=True)
        return (step, (placed, sh.place(mesh, opt, ospecs), batch),
                (pspecs, ospecs, in_batch_specs))

    if shape.kind == "prefill":
        buf = shape.seq_len if model.window is None \
            else min(shape.seq_len, model.window)

        def prefill_step(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch, buf_len=buf)

        return prefill_step, (placed, batch), (pspecs, in_batch_specs)

    # decode: one new token against a full cache
    buf = _decode_buf_len(model, shape)
    enc_len = (shape.seq_len // cfg.enc_frames_ratio
               if cfg.family == "audio" else 0)
    cache = model.init_cache(shape.global_batch, buf, enc_len)
    cspecs = sh.cache_specs(cfg, cache, mesh, shape.global_batch)
    tok_spec = (sh._batch_axes(mesh, shape.global_batch), None)
    tokens = sh.place(mesh, torch.empty((shape.global_batch, 1),
                                        dtype=torch.int32, device="meta"),
                      tok_spec)

    def serve_step(params, tokens, cache):
        with torch.no_grad():
            return model.decode_step(params, tokens, cache)

    return (serve_step, (placed, tokens, sh.place(mesh, cache, cspecs)),
            (pspecs, tok_spec, cspecs))


@contextlib.contextmanager
def _quiet_dtensor():
    """DTensor's advice on its redistributions (a fake group's all-to-all
    lowered to an all-gather, reductions over two mesh axes in turn) left
    out of the output: the counts carry what they cost."""
    loggers = [logging.getLogger(f"torch.distributed.tensor.{m}")
               for m in ("_redistribute", "_collective_utils")]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.ERROR)
    try:
        yield
    finally:
        for lg, level in zip(loggers, levels):
            lg.setLevel(level)


def _mesh_name(multi_pod: bool, mesh) -> str:
    if mesh is None:
        return "pod2x16x16" if multi_pod else "pod16x16"
    return "fake" + "x".join(map(str, mesh[0]))


def dry_run(arch: str, shape_name: str, multi_pod: bool,
            fmt: str = "bfloat16", kv_quant: bool = False, *,
            cfg: Optional[ModelConfig] = None,
            shape: Optional[ShapeConfig] = None,
            mesh: Optional[Tuple[Sequence[int], Sequence[str]]] = None):
    """The dry run of one combination: (its record, with the reference's
    keys; the :class:`~repro_torch.core.op_analysis.OpCost` of rank 0).
    ``cfg``, ``shape`` and ``mesh`` ((shape, axis names) of a fake mesh)
    replace the architecture's config, the named input shape and the
    production mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe as moe_mod
    mesh_shape, axes = mesh or production_shape(multi_pod)
    mesh_name = _mesh_name(multi_pod, mesh)
    t0 = time.time()
    shape = shape or INPUT_SHAPES[shape_name]
    model = make_model(arch, shape_name, fmt, kv_quant=kv_quant, cfg=cfg)
    with fake_mesh(mesh_shape, axes) as m, _quiet_dtensor():
        chips = n_chips(m)
        fn, args, _ = build_step(model, shape, m)
        t_lower = time.time() - t0
        with implicit_replication(), \
                moe_mod.expert_parallel(m, data_axes=data_axes(m)):
            out, cost = analyze_step(fn, *args)
        t_compile = time.time() - t0 - t_lower
        arg_bytes = tree_bytes(args)
        out_bytes = tree_bytes(out)
        del out, args
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": int(cost.peak_bytes),
           "fits": arg_bytes + cost.peak_bytes <= H100_SXM.hbm_capacity}
    mf = model_flops_for(model.cfg, shape)
    terms = terms_from_counts(cost, arch=arch, shape=shape_name,
                              mesh=mesh_name, n_chips=chips, model_flops=mf)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "fmt": fmt,
        "chips": chips,
        "hlo_flops": terms.hlo_flops,
        "hlo_bytes": terms.hlo_bytes,
        "collective_bytes": terms.collective_bytes,
        "collective_breakdown": terms.collective_breakdown,
        "parameter_bytes_per_chip": cost.parameter_bytes,
        "raw_cost_analysis": {
            "flops_per_chip_scan_once": cost.dot_flops,
            "bytes_per_chip_scan_once": cost.dot_bytes
            + cost.parameter_bytes,
        },
        "model_flops": mf,
        "memory_analysis": mem,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "window_override": model.window_override,
        "kv_quant": kv_quant,
        "ok": True,
        "roofline": {
            "t_compute_s": terms.t_compute, "t_memory_s": terms.t_memory,
            "t_collective_s": terms.t_collective,
            "bottleneck": terms.bottleneck,
            "useful_flop_ratio": terms.useful_flop_ratio,
            "roofline_fraction": terms.roofline_fraction,
        },
    }, cost


def run_one(arch: str, shape_name: str, multi_pod: bool,
            fmt: str = "bfloat16", force: bool = False,
            save: bool = True, kv_quant: bool = False, **kw
            ) -> Dict[str, Any]:
    """:func:`dry_run`'s record, cached as JSON under RESULTS_DIR (read
    back unless ``force``; written when ``save``). ``kw`` as
    :func:`dry_run`'s."""
    mesh_name = _mesh_name(multi_pod, kw.get("mesh"))
    tag = f"{fmt}__kvq" if kv_quant else fmt
    out_path = RESULTS_DIR / f"{arch}__{shape_name}__{mesh_name}__{tag}.json"
    if save and not force and out_path.exists():
        return json.loads(out_path.read_text())
    result, _ = dry_run(arch, shape_name, multi_pod, fmt, kv_quant, **kw)
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--fmt", default="bfloat16")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode hillclimb variant)")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                try:
                    r = run_one(arch, shape, mp, args.fmt,
                                force=args.force,
                                kv_quant=args.kv_quant)
                    rf = r["roofline"]
                    print(f"OK   {tag}: bottleneck={rf['bottleneck']} "
                          f"t=({rf['t_compute_s']:.2e},"
                          f"{rf['t_memory_s']:.2e},"
                          f"{rf['t_collective_s']:.2e})s "
                          f"compile={r.get('compile_s', '?')}s",
                          flush=True)
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e!r}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures")
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
