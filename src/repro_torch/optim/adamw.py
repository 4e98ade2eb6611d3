"""AdamW over a model's parameters, with ZeRO-1 optimizer-state specs
(the JAX package's ``optim/adamw.py``).

The f32 first and second moments are kept per parameter name.
``zero1_specs`` gives the specs a sharded run uses: each parameter's own
spec, plus its largest unsharded dimension over the "data" axis where
that divides it (ZeRO-1).  ``adamw_init(model, mesh=, specs=)`` places
the moments of a model whose parameters are DTensors by them, as the
reference's ``input_specs`` places its optimizer state; the update then
runs on the DTensors as it runs on plain tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..launch.sharding import PartitionSpec as P


@dataclasses.dataclass
class AdamWState:
    """``mu`` and ``nu``: f32 moments by parameter name (the names of
    ``model.named_parameters()``); ``step``: the number of updates taken,
    an int32 scalar on the parameters' device."""
    mu: dict
    nu: dict
    step: torch.Tensor


def adamw_init(model, mesh=None, specs=None) -> AdamWState:
    """Zero moments in f32 for every parameter of ``model``, on its
    device (a model on the meta device gives a skeleton to restore
    into).  With ``mesh`` and ``specs`` (the parameters' partition specs
    by name), the moments are DTensors placed by :func:`zero1_specs`
    (``launch.sharding.shard_tree``); else they are laid out as the
    parameters are (a DTensor's moments as DTensors of its placement)."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32,
                                    requires_grad=False)
                for n, p in params.items()}

    mu, nu = zeros(), zeros()
    if mesh is not None:
        from ..launch.mesh import axis_sizes
        from ..launch.sharding import shard_tree
        z1 = zero1_specs(specs, params, data_size=axis_sizes(mesh)["data"])
        mu, nu = shard_tree(mu, z1, mesh), shard_tree(nu, z1, mesh)
    return AdamWState(mu=mu, nu=nu,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _map(fn, specs, shapes):
    """``fn`` over the leaves of two matching trees (dicts, lists,
    tuples); a :class:`PartitionSpec` or None in ``specs`` is a leaf."""
    if specs is None or _is_spec(specs):
        return fn(specs, shapes)
    if isinstance(specs, dict):
        return {k: _map(fn, specs[k], shapes[k]) for k in specs}
    return type(specs)(_map(fn, s, t) for s, t in zip(specs, shapes))


def zero1_specs(param_specs, param_shapes, data_axis: str = "data",
                data_size: int = 1):
    """Optimizer-state specs: param spec + shard the largest unsharded dim
    over the data axis when divisible (ZeRO-1).  ``param_shapes`` matches
    ``param_specs`` and holds anything with a ``.shape`` (tensors on the
    meta device, say)."""
    def one(spec, shape):
        if not _is_spec(spec):
            spec = P()
        dims = tuple(shape.shape)
        entries = list(spec) + [None] * (len(dims) - len(spec))
        best, best_size = -1, 0
        for i, (e, dim) in enumerate(zip(entries, dims)):
            if e is None and dim % max(1, data_size) == 0 and dim > best_size:
                best, best_size = i, dim
        if best >= 0 and data_size > 1:
            entries[best] = data_axis
        return P(*entries)

    return _map(one, param_specs, param_shapes)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step, IN PLACE: ``params`` (name -> parameter) and
    ``state``'s moments and step are updated; returns the global grad
    norm (an f32 scalar on the device).  ``grads`` maps the same names to
    gradients; a missing or None gradient counts as zero.

    The reference's arithmetic (it returns new trees instead): the
    gradients clipped to a global norm of ``grad_clip`` in f32, bias
    correction from ``step + 1``, decoupled weight decay only on tensors
    with ``ndim >= 2`` (no decay on norms and biases), the update in f32
    and cast back to each parameter's type.  The element-wise steps run
    as ``torch._foreach_*`` ops over all tensors at once, in the
    reference's order."""
    names = list(params)
    ps = [params[n] for n in names]
    gs = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          if grads.get(n) is None else grads[n].float()
          for n, p in zip(names, ps)]
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    # global-norm clip in f32
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)

    state.step += 1
    step = state.step.float()
    c1 = 1.0 - torch.pow(b1, step)
    c2 = 1.0 - torch.pow(b2, step)

    g = torch._foreach_mul(gs, scale)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(nu, b2)
    gg = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_add_(nu, gg)
    den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
    torch._foreach_add_(den, eps)
    delta = torch._foreach_div(torch._foreach_div(mu, c1), den)
    p32 = [p.float() for p in ps]
    decay = [i for i, p in enumerate(ps) if p.ndim >= 2]   # not norms/biases
    if decay:
        torch._foreach_add_([delta[i] for i in decay], torch._foreach_mul(
            [p32[i] for i in decay], weight_decay))
    new = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
    if _is_dtensor(ps[0]):      # DTensor has no strategy for _foreach_copy_
        for p, x in zip(ps, new):
            p.copy_(x)
    else:
        torch._foreach_copy_(ps, new)
    return gnorm


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)
