"""Sharding resolution (the JAX package's ``launch/sharding.py``): turn
the models' abstract partition specs (axis names "data"/"model") into
mesh-specific ones, replacing "data" with ("pod", "data") on multi-pod
meshes and dropping axes that do not divide the corresponding dimension
(replicate instead of crash), and then into DTensor placements.

A spec names, per tensor dimension, the mesh axes it is split over; a
DTensor placement names, per mesh dimension, the tensor dimension split
over it.  :func:`named_sharding` turns one into the other (a dimension
split over ("pod", "data") is ``Shard`` on both, pod major, as the
reference's mesh orders them).  :func:`shard_tree` places tensors (a
module's parameters, a dict of inputs) as DTensors; tensors on the meta
device or under ``FakeTensorMode`` become DTensors whose local shards
hold no memory, so the 76B configurations are described without a
byte.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .mesh import axis_names, axis_sizes, dp_axes


class PartitionSpec(tuple):
    """One entry per array dimension: a mesh axis name, a tuple of axis
    names, or None (replicated).  The port's stand-in for
    ``jax.sharding.PartitionSpec``, as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(entry, tuple):
        return math.prod(sizes[a] for a in entry)
    return sizes[entry]


def resolve_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Map abstract spec -> concrete spec for this mesh."""
    if not isinstance(spec, P):
        spec = P()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e == "data":
            e = dp_axes(mesh) if len(dp_axes(mesh)) > 1 else "data"
        if e is not None and dim % _axis_size(mesh, e) != 0:
            # try just "data" before giving up
            if isinstance(e, tuple) and dim % axis_sizes(mesh)["data"] == 0:
                e = "data"
            else:
                e = None
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placement_mesh(mesh):
    """The ``DeviceMesh`` DTensors of ``mesh`` live on: ``mesh`` itself,
    or for the multi-pod (pod, data, model) mesh its (data, model) view
    over the same ranks, whose data axis is (pod, data) flattened pod
    major.  DTensor plans its redistributions on a 3-D mesh by a search
    that takes minutes an op; on the view each takes what it takes on
    the single-pod mesh."""
    names = axis_names(mesh)
    if "pod" not in names or not hasattr(mesh, "mesh_dim_names"):
        return mesh
    view = getattr(mesh, "_data_model_view", None)
    if view is None:
        from torch.distributed.device_mesh import init_device_mesh
        sizes = axis_sizes(mesh)
        view = init_device_mesh(mesh.device_type,
                                (sizes["pod"] * sizes["data"],
                                 sizes["model"]),
                                mesh_dim_names=("data", "model"))
        mesh._data_model_view = view
    return view


def named_sharding(spec: P, shape: tuple[int, ...], mesh) -> tuple:
    """The DTensor placements (one per dimension of
    :func:`placement_mesh`) of ``spec`` on a tensor of ``shape``, after
    :func:`resolve_spec`.  On a multi-pod mesh ("pod", "data") is the
    view's data axis; a dimension split over "data" alone (16 of its
    32 ways) has no placement there and is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    pod = "pod" in names
    placements = [Replicate()] * (2 if pod else len(names))
    for dim, entry in enumerate(resolve_spec(spec, shape, mesh)):
        if pod and entry == "data":
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None or (pod and axis == "pod"):
                continue
            placements[("data", "model").index(axis) if pod
                       else names.index(axis)] = Shard(dim)
    return tuple(placements)


def _place(t: torch.Tensor, placements, mesh):
    """``t`` as a DTensor with ``placements``: its data scattered when it
    has data, an empty local shard when it is on the meta device or a
    fake tensor (no memory)."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from torch._subclasses.fake_tensor import is_fake
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    if t.device.type != "meta" and not is_fake(t):
        return distribute_tensor(t, mesh, placements)
    local = list(t.shape)
    for size, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            if local[pl.dim] % size:
                raise ValueError(f"{tuple(t.shape)}: dim {pl.dim} does not "
                                 f"split {size} ways")
            local[pl.dim] //= size
    device = t.device if t.device.type == "meta" else mesh.device_type
    shard = torch.empty(local, dtype=t.dtype, device=device)
    return DTensor.from_local(shard, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_tree(tree, specs, mesh):
    """Place ``tree`` on ``mesh`` (its :func:`placement_mesh`) by
    ``specs``.

    * a module: each parameter is replaced, in place, by a DTensor placed
      by ``specs[state-dict name]`` (the module is returned);
    * a dict, list or tuple of tensors with a matching tree of specs: the
      same tree of DTensors.

    A leaf already a DTensor is redistributed."""
    if isinstance(tree, nn.Module):
        for name, prm in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            d = _place(prm.detach(),
                       named_sharding(specs[name], tuple(prm.shape), mesh),
                       placement_mesh(mesh))
            mod._parameters[leaf] = nn.Parameter(d, requires_grad=False)
        return tree
    if isinstance(tree, torch.Tensor):
        return _place(tree, named_sharding(specs, tuple(tree.shape), mesh),
                      placement_mesh(mesh))
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs))


def sharding_tree(tree, specs, mesh):
    """The placements :func:`shard_tree` would give, as a tree shaped
    like ``specs``: for a module, {state-dict name: placements}."""
    if isinstance(tree, nn.Module):
        return {n: named_sharding(specs[n], tuple(p.shape), mesh)
                for n, p in tree.named_parameters()}
    if isinstance(tree, torch.Tensor):
        return named_sharding(specs, tuple(tree.shape), mesh)
    if isinstance(tree, dict):
        return {k: sharding_tree(v, specs[k], mesh) for k, v in tree.items()}
    return type(tree)(sharding_tree(v, s, mesh) for v, s in zip(tree, specs))


def batch_spec(mesh, batch: int) -> P:
    """Global-batch leading axis sharding (replicate if indivisible)."""
    axes = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    size = math.prod(sizes[a] for a in axes)
    if batch % size == 0:
        return P(axes if len(axes) > 1 else axes[0])
    if batch % sizes["data"] == 0:
        return P("data")
    return P()


# ----------------------------------------------------------------------
# Running the models on DTensors
# ----------------------------------------------------------------------
_VIEWS = frozenset({"reshape", "view", "flatten", "unflatten"})
#: the products whose partial results are summed where they are made
_PRODUCTS = frozenset({"matmul", "__matmul__", "__rmatmul__", "einsum",
                       "mm", "bmm"})
#: ops with effects beyond their result, never retried
_NO_RETRY = frozenset({"backward", "copy_", "__setitem__"})


def _replicate(t, keep=()):
    """``t`` with every mesh dimension that shards a tensor dimension not
    in ``keep`` (and every partial one) made ``Replicate``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    pl = [p if p.is_replicate() or (isinstance(p, Shard) and p.dim in keep)
          else Replicate() for p in t.placements]
    return t if tuple(pl) == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def _kept_dims(src: tuple, dst: tuple) -> tuple[int, ...]:
    """The dimensions of ``src`` that a reshape to ``dst`` leaves as they
    are: the common leading and trailing sizes."""
    lead = 0
    while lead < min(len(src), len(dst)) and src[lead] == dst[lead]:
        lead += 1
    trail = 0
    while (trail < min(len(src), len(dst)) - lead
           and src[-1 - trail] == dst[-1 - trail]):
        trail += 1
    return tuple(range(lead)) + tuple(range(len(src) - trail, len(src)))


def _sum_partials(t, first=None):
    """``t`` with its partial placements summed (its splits kept)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def _aligned(t, first=None):
    """``t`` in the placement of ``first`` (partials summed) where both
    are DTensors of one shape (the operands of an element-wise op)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor) or first is None or \
            t.shape != first.shape:
        return t
    pls = _sum_partials(first).placements
    return _sum_partials(t).redistribute(t.device_mesh, pls)


def _staged(stage, args, kwargs):
    """(args, kwargs) with ``stage`` applied to every DTensor, or None
    when it changes nothing."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten, tree_map
    flat = tree_flatten((args, kwargs))[0]
    first = next((a for a in flat if isinstance(a, DTensor)), None)
    if stage is _replicate:
        out = tree_map(_replicate, (args, kwargs))
    else:
        out = tree_map(lambda t: stage(t, first), (args, kwargs))
    same = all(a is b for a, b in zip(flat, tree_flatten(out)[0]))
    return None if same and stage is not _replicate else out


def _replicated_call(func, args, kwargs):
    """``func`` on replicated DTensors that DTensor has no strategy for:
    every rank runs it on its whole copy, and the result is replicated
    (no gradient flows through it: the MoE's dispatch indices)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten, tree_map
    mesh = next(a for a in tree_flatten((args, kwargs))[0]
                if isinstance(a, DTensor)).device_mesh
    out = func(*tree_map(_to_local, args), **tree_map(_to_local, kwargs))
    return tree_map(lambda t: _from_replicated(t, mesh), out)


def _to_local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _from_replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, torch.Tensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


_META_EQUAL = []


def _meta_equal() -> None:
    """A meta kernel for ``torch.equal``, which has none: DTensor checks
    with it that a masked lookup's mask is reused unchanged, which on the
    meta device (no data) is taken as true.  Registered once."""
    if not _META_EQUAL:
        lib = torch.library.Library("aten", "IMPL")
        lib.impl("equal", lambda a, b: True, "Meta")
        _META_EQUAL.append(lib)


def _meta_bincount(x, minlength: int):
    """``torch.bincount(x, minlength=)`` on the meta device, where the
    length of the result depends on the data: taken as ``minlength``
    bins, as for the MoE router's expert ids, which lie below it."""
    from torch.distributed.tensor import DTensor
    out = torch.zeros(minlength, dtype=torch.int64, device="meta")
    if isinstance(x, DTensor):
        return _from_replicated(out, x.device_mesh)
    return out


class _PinGrad(torch.autograd.Function):
    """Identity whose backward hands its gradient on in the placements
    of its forward value: the view below it then maps the gradient back
    as the forward view mapped the value, which DTensor can always do."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Replicate
        ctx.mesh = t.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def _pin_grad(t):
    return _PinGrad.apply(t) if t.requires_grad else t


def _strided(t) -> bool:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    return isinstance(t, DTensor) and any(
        isinstance(p, _StridedShard) for p in t.placements)


class ShardedExecution:
    """Run unmodified model code on DTensors: the body of ``with
    ShardedExecution():`` treats plain tensors as replicated (DTensor's
    ``implicit_replication``), and where DTensor has no way to keep a
    sharding it gathers at that op, as XLA's partitioner inserts its
    collectives:

    * a reshape that splits or merges a sharded dimension in a way
      DTensor refuses (a head count that does not divide the model
      axis) or can only express as a strided shard first replicates the
      mesh dimensions that shard the dimensions it changes, and hands
      its gradient back in its output's placement (``_PinGrad``);
    * a product over a split contraction is all-reduced where it is made,
      and ``table[index]`` on a table split by rows is a masked lookup
      per shard and an all-reduce (``_lookup_rows``), as the partitioner
      reduces both;
    * ``logsumexp`` along a split dimension reduces a max and a sum
      across the ranks (``_logsumexp``) where DTensor would gather the
      dimension;
    * ``gather`` sums a partial input first, and along a split dimension
      gathers on each rank and sums (``_gather_split``);
    * ``dst[index] = src`` with a basic index on a DTensor writes each
      rank's shard (``setitem_sharded``), and an in-place update of a
      plain tensor from DTensors (``zeros(...).index_add_(...)``) runs
      out of place on it and its operands replicated: the caller uses
      its result;
    * any other out-of-place op whose sharding propagation fails is run
      again with its partial sums reduced, then with its same-shape
      operands in the first one's placement, then on replicated inputs,
      and an op DTensor has no strategy for at all (``searchsorted``)
      runs on each rank's whole copy of them;
    * on the meta device, ``bincount(x, minlength=n)`` gives ``n`` bins
      (its length depends on the data; the MoE's expert ids lie below
      ``n``), and ``torch.equal`` is true (``_meta_equal``).

    ``fallbacks`` counts, by op name, the ops that were gathered this
    way (the dry run records them).  In-place ops are never retried: a
    failure there raises."""

    def __init__(self):
        import collections
        from torch.overrides import TorchFunctionMode

        outer = self

        class _Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                return outer._call(func, args, kwargs or {})

        self.fallbacks = collections.Counter()
        self._mode = _Mode()
        self._implicit = None

    def _call(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten, tree_map
        name = getattr(func, "__name__", str(func))
        sharded = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, DTensor) and not all(
                       p.is_replicate() for p in a.placements)]
        if func is torch.Tensor.backward and len(args) == 1 and \
                not any(kwargs.values()):
            # the remat recompute runs inside the engine: keep the mode
            # on for it (Tensor.backward would dispatch back here)
            from torch.autograd import _make_grads
            from torch.autograd.graph import _engine_run_backward
            with self._mode:
                grads = _make_grads(args, (None,), is_grads_batched=False)
                _engine_run_backward(args, grads, False, False, (),
                                     allow_unreachable=True,
                                     accumulate_grad=True)
            return None
        if name == "bincount" and args[0].device.type == "meta" and \
                kwargs.get("minlength"):
            return _meta_bincount(args[0], kwargs["minlength"])
        dts = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, DTensor)]
        if dts and name.endswith("_") and not name.startswith("__") and \
                args and isinstance(args[0], torch.Tensor) and \
                not isinstance(args[0], DTensor):
            # a plain tensor updated in place from DTensors (the MoE's
            # combine into fresh zeros): the update out of place on it
            # taken as replicated, its operands replicated; the caller
            # uses the result
            self.fallbacks[name] += 1
            return getattr(torch.Tensor, name[:-1])(
                _from_replicated(args[0], dts[0].device_mesh),
                *tree_map(_replicate, args[1:]),
                **tree_map(_replicate, kwargs))
        if name in _PRODUCTS and sharded:
            # the partitioner all-reduces a product over a split
            # contraction where it is made (Megatron's row-parallel
            # all-reduce); left partial, it would make the next norm's
            # output and every later product partial, each rank then
            # multiplying by whole gathered weights
            return _sum_partials(self._sharded_call(name, func, args,
                                                    kwargs))
        if not sharded:
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError):
                if not dts or name in _NO_RETRY or name.endswith("_"):
                    raise
            # replicated DTensors only: every rank runs it on its copy
            self.fallbacks[name] += 1
            return _replicated_call(func, args, kwargs)
        return self._sharded_call(name, func, args, kwargs)

    def _sharded_call(self, name, func, args, kwargs):
        from torch.distributed.tensor import DTensor
        if name in _VIEWS and isinstance(args[0], DTensor):
            return _pin_grad(self._view(name, func, args, kwargs))
        if name == "__setitem__" and isinstance(args[0], DTensor) and \
                _basic_index(args[1]):
            return setitem_sharded(*args)
        if name == "logsumexp" and _split_along(args[0], kwargs.get(
                "dim", args[1] if len(args) > 1 else None)):
            return _logsumexp(*args, **kwargs)
        if name == "gather" and not kwargs and len(args) == 3 and \
                isinstance(args[0], DTensor):
            # a partial input is summed first (DTensor would gather it
            # into a masked partial kind that it cannot always reduce)
            x = _replicate(args[0], keep=range(args[0].ndim)) if any(
                p.is_partial() for p in args[0].placements) else args[0]
            if _split_along(x, args[1]):
                return _gather_split(x, *args[1:])
            return func(x, *args[1:])
        if name == "__getitem__" and isinstance(args[0], DTensor) and \
                args[0].ndim in (1, 2) and isinstance(args[1], torch.Tensor) \
                and not args[1].is_floating_point() and \
                args[1].dtype != torch.bool:
            return _lookup_rows(args[0], args[1])
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError, IndexError):
            if name in _NO_RETRY or name.endswith("_") or \
                    name.startswith("__set"):
                raise
        # gather as little as will do: the partial sums first, then the
        # operands of an element-wise op in the first one's placement,
        # then everything
        self.fallbacks[name] += 1
        for stage in (_sum_partials, _aligned, _replicate):
            staged = _staged(stage, args, kwargs)
            if staged is None:
                continue
            try:
                return func(*staged[0], **staged[1])
            except (RuntimeError, NotImplementedError, IndexError):
                if stage is not _replicate:
                    continue
            return _replicated_call(func, *staged)

    def _view(self, name, func, args, kwargs):
        try:
            out = func(*args, **kwargs)
            if not _strided(out):
                return out
        except (RuntimeError, NotImplementedError):
            pass
        src = args[0]
        dst = func(torch.empty(src.shape, device="meta"), *args[1:],
                   **kwargs).shape
        self.fallbacks[name] += 1
        return func(_replicate(src, _kept_dims(tuple(src.shape), tuple(dst))),
                    *args[1:], **kwargs)

    def __enter__(self):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        _meta_equal()
        self._implicit = implicit_replication()
        self._implicit.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._implicit.__exit__(*exc)


def _local(t, mesh, placements, grad_placements=None):
    """The local shard of ``t`` (a DTensor or a plain tensor taken as
    replicated) under ``placements``; its gradient comes back in
    ``grad_placements`` (default: ``placements``)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)


def _offsets(shape, mesh, placements) -> tuple[list[int], list[int]]:
    """(local sizes, global offsets) of this rank's shard of a tensor of
    ``shape`` placed so."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    size, off = compute_local_shape_and_global_offset(shape, mesh,
                                                      placements)
    return list(size), list(off)


def write_rows_sharded(cache, pos_vec, new) -> None:
    """``cache[b, pos_vec[b]] = new[b]`` on a DTensor cache (B, S, ...),
    IN PLACE on each rank's shard: the rank's rows of ``new`` and
    ``pos_vec`` are taken in the cache's placement; where S is split,
    the position is made local and a rank that does not hold it writes
    back what it has (a select, so nothing depends on the data)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pls = cache.device_mesh, tuple(cache.placements)

    def moved(p, drop):
        """``p`` for a tensor without dimension ``drop`` of the cache."""
        if not isinstance(p, Shard):
            return Replicate() if not p.is_replicate() else p
        if p.dim == drop:
            return Replicate()
        return Shard(p.dim - (p.dim > drop))

    size, off = _offsets(cache.shape, mesh, pls)
    loc = cache.to_local()
    rows = _local(new, mesh, [moved(p, 1) for p in pls]).to(loc.dtype)
    pos = _local(pos_vec, mesh, [Shard(0) if isinstance(p, Shard)
                                 and p.dim == 0 else Replicate()
                                 for p in pls])
    b_idx = torch.arange(size[0], device=loc.device)
    pos = pos - off[1]
    if size[1] == cache.shape[1]:
        loc[b_idx, pos] = rows
        return
    inside = (pos >= 0) & (pos < size[1])
    pos = pos.clamp(0, size[1] - 1)
    keep = loc[b_idx, pos]
    mask = inside.reshape((-1,) + (1,) * (rows.dim() - 1))
    loc[b_idx, pos] = torch.where(mask, rows, keep)


def _split_along(t, dim) -> bool:
    """Whether DTensor ``t`` is split along (one of) ``dim`` over a mesh
    dimension of more than one rank."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor) or dim is None:
        return False
    dims = {d % t.ndim for d in (dim if isinstance(dim, (tuple, list))
                                 else (dim,))}
    return any(isinstance(p, Shard) and p.dim in dims and n > 1
               for n, p in zip(t.device_mesh.shape, t.placements))


def _logsumexp(x, dim, keepdim=False):
    """``torch.logsumexp`` of a tensor split along ``dim`` as the
    partitioner computes it: the max and then the sum of the shifted
    exponentials, each reduced across the ranks (DTensor gathers the
    whole dimension for ``logsumexp`` itself)."""
    m = x.detach().amax(dim, keepdim=True)
    out = (x - m).exp().sum(dim, keepdim=True).log() + m
    return out if keepdim else out.squeeze(dim)


def _lookup_rows(table, index):
    """``table[index]`` for a DTensor table (V, d) or (V,) and an integer
    ``index``, as the partitioner computes an embedding: where the table is split
    by rows, each rank looks up the rows it holds (the others give 0)
    and the results are summed across the ranks that split the rows (an
    all-reduce); elsewhere the result follows the index's split.  DTensor's
    own index op would gather the table, and its masked embedding
    leaves a partial kind that some versions cannot add to the
    gradient of a tied head."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    index = index if isinstance(index, DTensor) else _from_replicated(
        index, mesh)
    idx_pls, out_pls = [], []
    for n, pt, pi in zip(mesh.shape, table.placements, index.placements):
        if isinstance(pt, Shard) and pt.dim == 0 and n > 1:
            idx_pls.append(Replicate())
            out_pls.append(Partial())
        else:
            pi = pi if isinstance(pi, Shard) else Replicate()
            idx_pls.append(pi)
            out_pls.append(pi)
    row_pls = [Shard(0) if isinstance(p, Partial) else Replicate()
               for p in out_pls]
    # a rank's rows get the gradient of its part of the index only
    rows = _local(table, mesh, row_pls, [
        Partial() if isinstance(o, Shard) else r
        for r, o in zip(row_pls, out_pls)])
    size, off = _offsets(table.shape, mesh, row_pls)
    idx = index.redistribute(mesh, idx_pls).to_local() - off[0]
    inside = (idx >= 0) & (idx < size[0])
    idx = idx.clamp(0, size[0] - 1)
    if rows.ndim == 2:
        got = torch.nn.functional.embedding(idx, rows)
        got = got * inside[..., None].to(got.dtype)
    else:
        got = rows[idx] * inside.to(rows.dtype)
    # summed at once, as the partitioner all-reduces a lookup: a partial
    # residual stream would make every later product partial, each rank
    # multiplying by whole gathered weights
    return DTensor.from_local(got, mesh, out_pls, run_check=False
                              ).redistribute(mesh, idx_pls)


def _gather_split(x, dim: int, index):
    """``x.gather(dim, index)`` with ``x`` split along ``dim``, as the
    partitioner computes it: each rank gathers the entries it holds
    (the others give 0) and the result is summed across the ranks that
    split ``dim``.  DTensor's own strategy makes the gradient as a
    zero tensor of the global shape on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, dim = x.device_mesh, dim % x.ndim
    idx_pls = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements]
    out_pls = [Partial() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements]
    size, off = _offsets(x.shape, mesh, x.placements)
    idx = _local(index, mesh, idx_pls) - off[dim]
    inside = (idx >= 0) & (idx < size[dim])
    loc = x.to_local()
    got = loc.gather(dim, idx.clamp(0, size[dim] - 1)) * inside.to(loc.dtype)
    return DTensor.from_local(got, mesh, out_pls, run_check=False)


def _basic_index(idx) -> bool:
    idx = idx if isinstance(idx, tuple) else (idx,)
    return all(isinstance(i, (int, slice)) or i is Ellipsis for i in idx)


def setitem_sharded(dst, idx, src) -> None:
    """``dst[idx] = src`` for a DTensor ``dst`` and a basic index (ints
    and slices), IN PLACE on each rank's shard: every dimension of
    ``dst`` that is split must be taken whole (``:``), so each rank
    writes the part it holds; ``src`` is taken in the placement of the
    view.  Anything else raises ``NotImplementedError``."""
    from torch.distributed.tensor import Shard
    idx = idx if isinstance(idx, tuple) else (idx,)
    if Ellipsis in idx:
        i = idx.index(Ellipsis)
        idx = idx[:i] + (slice(None),) * (dst.ndim - len(idx) + 1) + \
            idx[i + 1:]
    idx = idx + (slice(None),) * (dst.ndim - len(idx))
    view_dim, d = {}, 0
    for dim, i in enumerate(idx):
        if isinstance(i, slice):
            view_dim[dim] = d
            d += 1
    pls = []
    for p in dst.placements:
        if isinstance(p, Shard):
            if idx[p.dim] != slice(None):
                raise NotImplementedError(
                    f"setitem on a DTensor split along dim {p.dim} with "
                    f"index {idx[p.dim]!r}")
            pls.append(Shard(view_dim[p.dim]))
        elif p.is_replicate():
            pls.append(p)
        else:
            raise NotImplementedError(f"setitem on a partial DTensor {p}")
    loc = dst.to_local()
    loc[idx] = _local(src, dst.device_mesh, pls).to(loc.dtype)


def sharded_zeros(shape, dtype, spec, like):
    """Zeros of the global ``shape`` as a DTensor on ``like``'s mesh,
    placed by the partition ``spec``: each rank makes only its shard,
    on the device of ``like``'s."""
    from torch.distributed.tensor import DTensor
    mesh = like.device_mesh
    pls = named_sharding(spec, tuple(shape), mesh)
    local = list(shape)
    for n, p in zip(mesh.shape, pls):
        if hasattr(p, "dim") and not p.is_replicate():
            local[p.dim] //= n
    shard = torch.zeros(local, dtype=dtype, device=like.to_local().device)
    return DTensor.from_local(shard, mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def per_head_shard(fn, q, k, v, *args, batch_args=(), **kwargs):
    """``fn(q, k, v, *args, *batch_args, **kwargs)`` for attention over
    DTensors q (B, Sq, H, D), k and v (B, Sk, KV, D), run on each rank's
    shard as ``local_map`` would: each mesh dimension keeps q's split
    over the batch (if it divides B) or over the heads (if it divides
    both H and KV, so each shard keeps the GQA mapping), else
    replicates; q, k and v are placed alike, each of ``batch_args`` (B,
    ...) split as the batch is, and ``fn`` sees the local shards (plain
    tensors: on the card, K4); its output is a DTensor of q's placement.
    Differentiable.  Without it DTensor plans the products' own
    placements and can move the whole score tensor or cache between
    ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    B, H, KV = q.shape[0], q.shape[2], k.shape[2]
    pls = []
    for n, p in zip(mesh.shape, q.placements):
        keep = isinstance(p, Shard) and (
            (p.dim == 0 and B % n == 0)
            or (p.dim == 2 and H % n == 0 and KV % n == 0))
        pls.append(p if keep else Replicate())
    local = [_local(t, mesh, pls) for t in (q, k, v)]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pls]
    extra = [_local(t, mesh, rows) for t in batch_args]
    out = fn(*local, *args, *extra, **kwargs)
    return DTensor.from_local(out, mesh, pls, run_check=False)


def per_head_block(fn, x, rows, heads, *args):
    """``fn(x, *rows, *heads, *args)`` -> (B, S, H, ...) for a block of
    per-head products over DTensors (the MLA's absorbed attention), run
    on each rank's shard as ``local_map`` would: x (B, S, d) keeps its
    split of B where it divides, the head weights (..., H, ... with the
    heads at dimension 1) their split of H where it divides; each of
    ``rows`` (B or 1, ...) is split as the batch is, or whole.  ``fn``
    sees plain local tensors, so neither its products nor their
    backward reshape a split dimension; gradients come back partial
    over the splits their tensor was whole along.  The output is split
    as x's batch and the weights' heads."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, B, H = x.device_mesh, x.shape[0], heads[0].shape[1]
    roles = []
    for i, n in enumerate(mesh.shape):
        px = x.placements[i]
        pw = heads[0].placements[i] if isinstance(heads[0], DTensor) \
            else Replicate()
        if isinstance(px, Shard) and px.dim == 0 and B % n == 0:
            roles.append("batch")
        elif isinstance(pw, Shard) and pw.dim == 1 and H % n == 0:
            roles.append("heads")
        else:
            roles.append(None)

    def placed(split, dim, grad_other):
        pls = [Shard(dim) if r == split else Replicate() for r in roles]
        grads = [Shard(dim) if r == split else
                 (Partial() if r == grad_other else Replicate())
                 for r in roles]
        return pls, grads

    batch_pls, batch_grads = placed("batch", 0, "heads")
    whole = [Replicate()] * mesh.ndim
    whole_grads = [Partial() if r else Replicate() for r in roles]
    local_rows = [
        _local(t, mesh, batch_pls, batch_grads) if t.shape[0] == B
        else _local(t, mesh, whole, whole_grads) for t in rows]
    local_heads = [_local(w, mesh, *placed("heads", 1, "batch"))
                   for w in heads]
    out = fn(_local(x, mesh, batch_pls, batch_grads), *local_rows,
             *local_heads, *args)
    out_pls = [Shard(0) if r == "batch" else
               Shard(2) if r == "heads" else Replicate() for r in roles]
    return DTensor.from_local(out, mesh, out_pls, run_check=False)


def per_batch_shard(fn, params, x, *args, state=None):
    """``fn(params, x, *args, state=state)`` -> (y, new state) for a
    block whose inputs are DTensors, run on each rank's batch shard as
    ``local_map`` would: x (B, ...) and each state leaf (B, ...) keep
    x's split of B where it divides, else are replicated; ``params``'
    own tensors come whole to every rank (their gradients partial over
    the batch split); y and the new state come back in x's placement.
    For a sequential recurrence (the sLSTM), whose per-position steps
    DTensor would dispatch one by one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, B = x.device_mesh, x.shape[0]
    pls = [p if isinstance(p, Shard) and p.dim == 0 and B % n == 0
           else Replicate() for n, p in zip(mesh.shape, x.placements)]
    grad_pls = [Partial() if isinstance(p, Shard) else Replicate()
                for p in pls]
    whole = [Replicate()] * mesh.ndim
    local_p = {k: _local(v, mesh, whole, grad_pls)
               for k, v in params._parameters.items()}
    local_state = None if state is None else tuple(
        _local(t, mesh, pls) for t in state)
    y, new = fn(local_p, _local(x, mesh, pls), *args, state=local_state)
    wrap = lambda t: DTensor.from_local(t, mesh, pls,  # noqa: E731
                                        run_check=False)
    return wrap(y), tuple(wrap(t) for t in new)
