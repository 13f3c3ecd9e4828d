"""The port's dry run (``repro_torch.launch.dryrun``): the step of a
reduced config on a fake (2, 4) mesh, in bf16 and int8, for a train, a
prefill and a decode shape (the reference's tiny ShapeConfig); its record
keeps the reference's keys, its argument bytes are exactly the local
bytes of the placed arguments, both launchers' ``--dry`` runs their full
default configs on the production mesh, and the saved records are
coherent (the twin of the reference's artifact check)."""
import ast
import contextlib
import io
import json
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun, sharding as sh
from repro_torch.launch.mesh import fake_mesh

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 4), ("data", "model"))
SHAPES = [ShapeConfig("tiny_train", 64, 4, "train"),
          ShapeConfig("tiny_prefill", 64, 4, "prefill"),
          ShapeConfig("tiny_decode", 64, 4, "decode")]
CFG = get_config("minitron-8b").reduced()


def _reference_keys():
    """The keys of the reference's record (``run_one``'s ``result`` and its
    ``roofline``), read from its source: importing it would set the
    process's XLA flags."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    keys = {}
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], (ast.Name, ast.Subscript))):
            t = node.targets[0]
            name = t.id if isinstance(t, ast.Name) else t.slice.value
            keys[name] = {k.value for k in node.value.keys}
    return keys["result"] | {"roofline"}, keys["roofline"]


def _run(shape, fmt, **kw):
    return dryrun.run_one("minitron-8b", shape.name, False, fmt, save=False,
                          cfg=CFG, shape=shape, mesh=MESH, **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("fmt", ["bfloat16", "int8"])
def test_run_one_on_a_fake_mesh(shape, fmt):
    if fmt == "int8" and shape.kind == "train":
        # integer weights have no gradient: the reference cannot take
        # this step either (jax.value_and_grad refuses int8 leaves)
        with pytest.raises(RuntimeError, match="floating point"):
            _run(shape, fmt)
        return
    r = _run(shape, fmt)
    top, roof = _reference_keys()
    assert set(r) == top
    assert set(r["roofline"]) == roof
    assert r["ok"] and r["chips"] == 8 and r["mesh"] == "fake2x4"
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")
    mem = r["memory_analysis"]
    assert mem["temp_size_in_bytes"] > 0 and mem["fits"]
    assert r["parameter_bytes_per_chip"] == mem["argument_size_in_bytes"]
    # rank 0's counts, times the chips
    assert r["hlo_flops"] == 8 * r["raw_cost_analysis"][
        "flops_per_chip_scan_once"]
    if shape.kind != "train":
        assert r["collective_breakdown"]["all-reduce"] > 0


def _spec_bytes(t, spec, sizes):
    n = t.element_size()
    for i, dim in enumerate(t.shape):
        e = spec[i]
        axes = (e,) if isinstance(e, str) else (e or ())
        n *= dim // math.prod(sizes[a] for a in axes)
    return n


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
def test_argument_bytes_are_the_placed_shards(shape):
    """The record's argument bytes, the local bytes of the DTensors
    build_step places, and the bytes the specs give each rank of the
    global shapes are one number."""
    model = dryrun.make_model("minitron-8b", shape.name, cfg=CFG)
    sizes = dict(zip(MESH[1], MESH[0]))
    with fake_mesh(*MESH) as mesh:
        _, args, specs = dryrun.build_step(model, shape, mesh)
        local = sum(t.to_local().numel() * t.element_size()
                    for t in torch.utils._pytree.tree_leaves(args))
        want = 0
        for tree, spec in zip(args, specs):
            pieces = []
            sh.map_tree(lambda p, t, s: pieces.append(
                _spec_bytes(t, s, sizes)), tree, spec)
            want += sum(pieces)
    assert local == want
    assert _run(shape, "bfloat16")["memory_analysis"][
        "argument_size_in_bytes"] == want


@pytest.mark.parametrize("launcher,line", [
    ("serve", "dry serve_step lower+compile OK"),
    ("train", "dry train_step lower+compile OK")])
def test_launchers_dry_run_their_full_default_configs(launcher, line):
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(["--dry"])
    assert out.getvalue().strip().splitlines()[-1] == line


def test_dryrun_artifacts(tmp_path, monkeypatch):
    """A saved record is read back as it was written, and every record
    under the results directories is coherent (the reference's check)."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    r = dryrun.run_one("stablelm-1.6b", "decode_32k", False)
    again = dryrun.run_one("stablelm-1.6b", "decode_32k", False)
    assert again == json.loads(json.dumps(r))
    files = sorted(tmp_path.glob("*.json")) \
        + sorted((ROOT / "experiments" / "dryrun_torch").glob("*.json"))
    assert files
    for p in files:
        rec = json.loads(p.read_text())
        assert rec["ok"]
        assert rec["hlo_flops"] > 0
        assert rec["hlo_bytes"] > 0
        assert rec["chips"] in (256, 512)
        assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                                 "collective")
