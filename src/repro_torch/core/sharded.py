"""Running the model on DTensors: the dry run's sharded path.

The dry run (:mod:`repro_torch.launch.dryrun`) places every parameter,
input and cache as a DTensor on the ``meta`` device. DTensor has no
sharding rule for some of the model's operations (the hand-written
kernels, the SSD scan, the in-place cache writes, the vocabulary lookups,
the MoE layer); the helpers here run those on each rank's shards
(:func:`on_shards`, over ``local_map``) with explicit placements, and
insert the collectives a sharded program needs (:func:`reduce_partial`,
:func:`gather_dim`). :func:`matmul_placements` is the one rule for a
product against a sharded weight, plain (:func:`sharded_matmul`) or
quantized (the quant kernels' wrappers).

DTensors occur only on the ``meta`` device, so :func:`is_sharded` reads
one tensor's device on any other and the CPU and CUDA paths pay one
attribute read for it. The spec rules that decide the placements live
one layer up, in :mod:`repro_torch.launch.sharding`.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch


def is_sharded(*tensors) -> bool:
    """Whether any of ``tensors`` is a DTensor (the dry run's path). A
    DTensor lives on the ``meta`` device: a first tensor on another
    device answers at once."""
    if not tensors[0].is_meta:
        return False
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tensors)


def axis_size(mesh, name: str) -> int:
    """The size of the mesh axis ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def placements(mesh, spec) -> list:
    """The DTensor placements of ``spec`` (one entry per tensor dim:
    ``None``, an axis name or a tuple of them) on ``mesh``: Shard(d) on
    each mesh axis that spec names for tensor dim d, Replicate on the
    others. Two axes on one dim (("pod", "data")) shard it major to
    minor."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def on_shards(fn: Callable, out_placements, *args: Any,
              in_placements: Optional[Sequence] = None,
              in_grad_placements: Optional[Sequence] = None, **kwargs):
    """``fn(*args, **kwargs)`` on each rank's shards (``local_map``): the
    DTensor arguments enter as their local tensors, with their own
    placements unless ``in_placements`` (one entry per tensor leaf of
    ``args``, flattened as ``torch.utils._pytree`` does; None for a
    non-DTensor leaf) asks for others, to which they are redistributed;
    the outputs leave as DTensors with ``out_placements`` (a placement
    list, or a tuple of them for several outputs). ``in_grad_placements``
    (as ``in_placements``) places the local gradients of the inputs in
    the backward; by default they are placed as the inputs."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_leaves, tree_map
    leaves = tree_leaves(args)
    if in_placements is None:
        in_placements = [a.placements if isinstance(a, DTensor) else None
                         for a in leaves]
    in_pl = tuple(None if p is None else tuple(p) for p in in_placements)
    mesh = next(a.device_mesh for a in leaves if isinstance(a, DTensor))
    if any(isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
           and p is not None for a, p in zip(leaves, in_pl)):
        # a plain tensor given placements is a replicated value
        args = tree_map(
            lambda a: DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            else a, args)
    grad_pl = None if in_grad_placements is None else tuple(
        None if p is None else tuple(p) for p in in_grad_placements)
    return local_map(fn, out_placements=out_placements, in_placements=in_pl,
                     in_grad_placements=grad_pl,
                     redistribute_inputs=True)(*args, **kwargs)


def by_table(fn: Callable, dims, *args):
    """``fn(*args)``; on DTensors on each rank's shards. ``dims`` is a
    pair of tables, each with one entry per argument and then per output:
    its rows dim, and its heads (or channels) dim; None for replicated.
    On a mesh axis that splits the first argument's rows (its dim 0),
    every argument and output is split on its rows dim; on the ``model``
    axis, when it divides the first argument's heads, on its heads dim;
    elsewhere all are replicated."""
    if not is_sharded(*args):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    rows, heads = dims
    lead = args[0]
    mesh = lead.device_mesh
    pls = [[] for _ in rows]
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, lead.placements)):
        if isinstance(p, Shard) and p.dim == 0:
            pick = rows
        elif name == "model" and lead.shape[heads[0]] % mesh.size(i) == 0:
            pick = heads
        else:
            pick = (None,) * len(rows)
        for lst, d in zip(pls, pick):
            lst.append(Replicate() if d is None else Shard(d))
    outs = pls[len(args):]
    return on_shards(fn, outs[0] if len(outs) == 1 else tuple(outs), *args,
                     in_placements=pls[:len(args)])


def reduce_partial(t):
    """A DTensor's pending sums reduced (one all-reduce), its other
    placements kept."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(placements=[Replicate() if p.is_partial() else p
                                      for p in t.placements])


def matmul_placements(x, w):
    """How x (..., K) @ w (..., K, N) runs shard by shard, mesh axis by
    mesh axis, as tensor-parallel layers lay it out; w's placements
    decide. On an axis that splits w's columns, x enters replicated and
    the output is split on its columns. On one that splits w's rows
    (``wo``, ``w_down``), x enters split on its features and the output
    is a partial sum. On one that splits w's leading (expert) dim, x and
    the output are split on theirs. On one that leaves w whole, x's rows
    stay split where they are (the data axes), and so are the output's.
    Returns the placements of (x, the output, x's gradient, w's
    gradient)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    x_pl, out_pl, dx_pl, dw_pl = [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(wp, Shard) and wp.dim == w.ndim - 1:
            pick = (Replicate(), Shard(last), Partial(), wp)
        elif isinstance(wp, Shard) and wp.dim == w.ndim - 2:
            pick = (Shard(last), Partial(), Shard(last), wp)
        elif isinstance(wp, Shard):
            pick = (Shard(0), Shard(0), Shard(0), wp)
        elif isinstance(xp, Shard) and xp.dim < last:
            pick = (xp, xp, xp, Partial())
        else:
            pick = (Replicate(),) * 4
        for lst, p in zip((x_pl, out_pl, dx_pl, dw_pl), pick):
            lst.append(p)
    return x_pl, out_pl, dx_pl, dw_pl


def sharded_matmul(x, w, dtype):
    """x @ w in ``dtype`` on DTensors, shard by shard
    (:func:`matmul_placements`); a partial sum is reduced at once
    (:func:`reduce_partial`)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x, w = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (x, w))
    x_pl, out_pl, dx_pl, dw_pl = matmul_placements(x, w)
    y = on_shards(lambda a, b: torch.matmul(a.to(dtype), b.to(dtype)),
                  out_pl, x, w, in_placements=[x_pl, w.placements],
                  in_grad_placements=[dx_pl, dw_pl])
    return reduce_partial(y)


def gather_dim(t, dim: int, groups: int = 0):
    """t with its dim ``dim`` gathered (one all-gather) on the mesh axes
    that split it, unless those axes split it into whole ``groups`` (their
    sizes' product divides the group count): before a slice, or a view
    that would split it unevenly."""
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.ndim
    axes = [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == dim]
    size = 1
    for i in axes:
        size *= t.device_mesh.size(i)
    if not axes or (groups and groups % size == 0):
        return t
    return t.redistribute(placements=[Replicate() if i in axes else p
                                      for i, p in enumerate(t.placements)])


def gather_last(t, heads: int = 0):
    """:func:`gather_dim` on the last dim."""
    return gather_dim(t, -1, heads)


def split_heads(t, n: int, hd: int):
    """t (..., n * hd) viewed as (..., n, hd); on DTensors first gathered
    where the mesh would split the heads unevenly."""
    if is_sharded(t):
        t = gather_last(t, heads=n)
    return t.reshape(*t.shape[:-1], n, hd)


def split_lookup(pick: Callable, table, ids, ids_placements, dim: int):
    """``pick(table_shard, ids, inside)`` on DTensors whose ``table`` may
    be split on its dim ``dim`` (a vocabulary): each rank picks the ids
    that fall in its part (``inside``; ids shifted to the part, clamped
    into it), zero elsewhere, and one all-reduce sums the parts, the
    reference's lowering. The ids enter placed as ``ids_placements``
    on the other mesh axes, and so leaves the result."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    dim %= table.ndim
    in_ids, out, split = [], [], None
    for i, (ip, tp) in enumerate(zip(ids_placements, table.placements)):
        if isinstance(tp, Shard) and tp.dim == dim:
            in_ids.append(Replicate())
            out.append(Partial())
            split = i
        else:
            in_ids.append(ip)
            out.append(ip)

    def local(tab, idx):
        n = tab.shape[dim]
        idx = idx.long() - (0 if split is None
                            else mesh.get_local_rank(split) * n)
        return pick(tab, idx.clamp(0, n - 1), (idx >= 0) & (idx < n))

    return reduce_partial(on_shards(local, out, table, ids,
                                    in_placements=[table.placements,
                                                   in_ids]))
