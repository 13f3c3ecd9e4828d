"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``) on both production meshes, for
every ``ARCH_IDS`` config at full width in bf16, int8 and nf4.

The port's params are lists of layers, the reference's are stacked with
the layer axis first: each per-layer leaf must get the reference's spec
with that axis dropped, and each decode cache the reference's spec. The
parameter bytes each GPU holds must equal the reference's; so must the
optimizer moments', but for the leaves named in ``MOMENT_DIFFS``
(ROADMAP C13): the ZeRO shard takes the first replicated dim that the
data axis divides, which in the reference can be the stacked layer axis.

The reference runs on a stand-in mesh carrying ``.shape`` and
``.axis_names`` (its rules read nothing else) over ``jax.eval_shape``
params; its quantized leaves are its own ``_quantize_leaf`` of one
layer's slice with the stacked axes put back, which is how its
``quantize_params`` stacks them."""
import functools
import math
from typing import Dict, Tuple

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core.precision import make_policy as jax_policy
from repro.launch import sharding as jsh
from repro.models import build_model as jax_build_model
from repro.quant import apply as jax_apply
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
from repro_torch.launch import dryrun, sharding as sh
from repro_torch.launch.mesh import fake_mesh, production_shape
from repro_torch.training.optimizer import adamw_init

FORMATS = ("bfloat16", "int8", "nf4")
MESHES = (False, True)                      # multi_pod
STACKED = ("layers", "enc_layers")

#: (arch, reference moment path) whose bytes per GPU differ from the
#: port's, and why: the reference's ZeRO shard lands on the stacked layer
#: axis (64 layers of mamba2 on data = 16) where the port's per-layer leaf
#: has no replicated dim the data axis divides (ROADMAP C13)
MOMENT_DIFFS = {
    ("mamba2-2.7b", "layers/conv_w"), ("mamba2-2.7b", "layers/conv_b"),
    ("mamba2-2.7b", "layers/A_log"), ("mamba2-2.7b", "layers/D"),
    ("mamba2-2.7b", "layers/dt_bias"), ("mamba2-2.7b", "layers/gate_norm"),
}


class JaxMeshStandIn:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, fmt: str):
    m = jax_build_model(jax_get_config(arch), fmt=fmt)
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    if fmt == "bfloat16":
        return params
    pol = jax_policy(fmt)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if tree.ndim < 2:
            return tree
        one = jax.eval_shape(
            lambda w: jax_apply._quantize_leaf(path, w, pol),
            jax.ShapeDtypeStruct(tree.shape[-2:], tree.dtype))
        if not hasattr(one, "_fields"):
            return tree
        lead = tree.shape[:-2]
        return jax.tree.map(lambda f: jax.ShapeDtypeStruct(
            lead + f.shape, f.dtype), one)

    return walk(params)


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, fmt: str):
    m = dryrun.make_model(arch, "train_4k", fmt)
    return m.abstract_params(quantize=m.policy.is_quantized)


def _ref_flat(tree) -> Dict[str, Tuple]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {jsh._path_str(kp): v for kp, v in leaves}


def _port_flat(tree) -> Dict[str, list]:
    """Leaves by the reference's path: a layer's index is dropped, and
    the layers' leaves gathered in a list."""
    out: Dict[str, list] = {}

    def add(path, leaf):
        parts = path.split("/")
        if parts[0] in STACKED:
            del parts[1]
        out.setdefault("/".join(parts), []).append(leaf)

    sh.map_tree(add, tree)
    return out


def _norm(spec) -> tuple:
    """A spec with one-axis tuples written as the axis (PartitionSpec
    normalizes them so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _local_bytes(shape, spec, sizes, itemsize) -> int:
    n = 1
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = (e,) if isinstance(e, str) else (e or ())
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * itemsize


def _meshes(multi_pod):
    shape, axes = production_shape(multi_pod)
    return shape, axes, JaxMeshStandIn(shape, axes)


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_reference_without_the_layer_axis(arch, fmt,
                                                              multi_pod):
    shape, axes, jmesh = _meshes(multi_pod)
    sizes = dict(zip(axes, shape))
    ref_params = _ref_params(arch, fmt)
    ref = _ref_flat(jsh.param_specs(ref_params, jmesh))
    ref_shapes = _ref_flat(ref_params)
    params = _port_params(arch, fmt)
    with fake_mesh(shape, axes) as mesh:
        port = _port_flat(sh.param_specs(params, mesh))
    port_shapes = _port_flat(params)
    assert set(port) == set(ref)
    ref_bytes = port_bytes = 0
    for path, spec in ref.items():
        stacked = path.split("/")[0] in STACKED
        want = tuple(spec)[1:] if stacked else tuple(spec)
        assert all(s == want for s in port[path]), (path, port[path], spec)
        leaf = ref_shapes[path]
        ref_bytes += _local_bytes(leaf.shape, tuple(spec), sizes,
                                  leaf.dtype.itemsize)
        port_bytes += sum(
            _local_bytes(t.shape, s, sizes, t.element_size())
            for t, s in zip(port_shapes[path], port[path]))
    assert port_bytes == ref_bytes


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_are_the_references(arch, shape_name, multi_pod):
    shape, axes, jmesh = _meshes(multi_pod)
    s = INPUT_SHAPES[shape_name]
    model = dryrun.make_model(arch, shape_name)
    buf = dryrun._decode_buf_len(model, s)
    cfg = model.cfg
    enc = s.seq_len // cfg.enc_frames_ratio if cfg.family == "audio" else 0
    jm = jax_build_model(jax_get_config(arch),
                         window_override=model.window_override)
    jcache = jax.eval_shape(lambda: jm.init_cache(s.global_batch, buf, enc))
    ref = jsh.cache_specs(jax_get_config(arch), jcache, jmesh,
                          s.global_batch)
    cache = model.init_cache(s.global_batch, buf, enc)
    with fake_mesh(shape, axes) as mesh:
        port = sh.cache_specs(cfg, cache, mesh, s.global_batch)
    assert {k: _norm(v) for k, v in ref.items()} == {
        k: _norm(v) for k, v in port.items()}
    for k, v in cache.items():
        assert tuple(v.shape) == tuple(jcache[k].shape), k


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_moment_bytes_per_gpu_are_the_references(arch, multi_pod):
    """bf16 (the train format): the moments' bytes each GPU holds, leaf
    by leaf, equal the reference's but for ``MOMENT_DIFFS``."""
    shape, axes, jmesh = _meshes(multi_pod)
    sizes = dict(zip(axes, shape))
    ref_params = _ref_params(arch, "bfloat16")
    ref_opt = jax.eval_shape(jax_adamw_init, ref_params)
    ref_os = jsh.opt_specs(ref_opt, jsh.param_specs(ref_params, jmesh),
                           jmesh)
    ref_spec, ref_leaf = _ref_flat(ref_os["m"]), _ref_flat(ref_opt["m"])
    params = _port_params(arch, "bfloat16")
    opt = adamw_init(params)
    with fake_mesh(shape, axes) as mesh:
        os_ = sh.opt_specs(opt, sh.param_specs(params, mesh), mesh)
    port_spec, port_leaf = _port_flat(os_["m"]), _port_flat(opt["m"])
    assert os_["v"] == os_["m"] and os_["step"] == ()
    differ = set()
    for path, spec in ref_spec.items():
        leaf = ref_leaf[path]
        ref_b = _local_bytes(leaf.shape, tuple(spec), sizes, 4)
        port_b = sum(_local_bytes(t.shape, s, sizes, 4)
                     for t, s in zip(port_leaf[path], port_spec[path]))
        if port_b != ref_b:
            differ.add((arch, path))
    assert differ == {d for d in MOMENT_DIFFS if d[0] == arch}


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    shape, axes = production_shape(True)
    with fake_mesh(shape, axes) as mesh:
        assert sh.placements(mesh, (("pod", "data"), None, "model")) == [
            Shard(0), Shard(0), Shard(2)]
        assert sh.placements(mesh, (None, None)) == [Replicate()] * 3
        t = sh.place(mesh, {"w": torch.empty((64, 32), device="meta")},
                     {"w": ("data", "model")})["w"]
        assert t.to_local().shape == (4, 2)
        assert sh.named(mesh, {"a": ("model",)}) == {
            "a": [Replicate(), Replicate(), Shard(0)]}
