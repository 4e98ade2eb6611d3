"""Carry descriptions and weights across from the JAX package to the
port.

What crosses between the two packages is the description of a design
point (architecture, SAFs, workload, mapping), of a model configuration
and the matmuls extracted from it, packed parameter rows, and the weights
of a language model.  :func:`from_reference` turns the JAX package's
description objects into the port's equivalents by dataclass field and
enum member *name*, without importing the JAX package, so one
description can be fed through both (the tests do).  Packed rows cross
as numpy: ``core.arch.ArchParams.from_numpy`` and
``core.batched.WorkloadParams`` turn them into tensors on a device.
:func:`params_from_reference` fills the port's model of any family
from the reference's parameters given as nested dicts of numpy arrays,
and :func:`opt_state_from_reference` the port's optimizer state from the
reference's, so both packages can take a training step from one state.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch
from torch import nn

from .core.arch import Architecture, ArchParams, ComputeLevel, StorageLevel
from .core.device import resolve_device
from .core.engine import Design
from .core.mapping import Loop, LoopNest
from .core.taxonomy import (ActionSAF, RankFormat, SAFKind, SAFSpec,
                            TensorFormat)
from .core.workload import TensorSpec, Workload
from .fleet.extract import LayerMatmul, MeshSpec, NetworkWorkloads
from .models.config import HybridConfig, MLAConfig, MoEConfig, ModelConfig
from .models.transformer import get_api

#: the port's description classes, by the name they share with the JAX
#: package's
_CLASSES = {c.__name__: c for c in (
    Architecture, ArchParams, ComputeLevel, StorageLevel, Design, Loop,
    LoopNest, ActionSAF, SAFSpec, TensorFormat, TensorSpec, Workload,
    ModelConfig, MoEConfig, MLAConfig, HybridConfig, LayerMatmul,
    NetworkWorkloads, MeshSpec)}
_ENUMS = {e.__name__: e for e in (RankFormat, SAFKind)}


def from_reference(obj):
    """The port's equivalent of a JAX-package description object.

    Dataclasses (``Design``, ``Architecture``, ``SAFSpec``, ``Workload``,
    ``LoopNest``, ``ModelConfig``, ``LayerMatmul``, ``NetworkWorkloads``,
    ``MeshSpec`` and the ones inside them) are rebuilt field by field,
    enums (``RankFormat``, ``SAFKind``) by member name; tuples, lists and
    dicts are converted element-wise, and anything else (numbers,
    strings, numpy arrays in density specs) is passed through.  Objects
    that already belong to the port pass through unchanged."""
    if isinstance(obj, enum.Enum):
        port = _ENUMS.get(type(obj).__name__)
        if port is None:
            raise TypeError(f"no port equivalent of enum "
                            f"{type(obj).__qualname__}")
        return port[obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if type(obj).__module__.startswith(__package__ + "."):
            return obj
        port = _CLASSES.get(type(obj).__name__)
        if port is None:
            raise TypeError(f"no port equivalent of "
                            f"{type(obj).__qualname__}")
        return port(**{f.name: from_reference(getattr(obj, f.name))
                       for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {from_reference(k): from_reference(v)
                for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_reference(v) for v in obj)
    return obj


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":    # ml_dtypes: exact through f32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _port_keys(params, model, cfg) -> dict:
    """The reference's tree of numpy arrays flattened to the state-dict
    keys of the port's ``model``: the groups stacked over a leading
    layer axis are split over it; raises ``ValueError`` on a missing or
    extra key or a wrong stack count."""
    flat = {}
    for key, arr in _flatten(params):
        group = key.split(".", 1)[0]
        if group in model and isinstance(model[group], nn.ModuleList):
            n = len(model[group])
            arr = np.asarray(arr)
            if arr.ndim == 0 or arr.shape[0] != n:
                raise ValueError(f"{key}: {arr.shape} is not stacked over "
                                 f"the port's {n} {group}")
            for layer in range(n):
                flat[f"{group}.{layer}.{key[len(group) + 1:]}"] = arr[layer]
        else:
            flat[key] = arr
    want = model.state_dict()
    missing = sorted(want.keys() - flat.keys())
    extra = sorted(flat.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"reference parameters do not match the port's "
                         f"{cfg.name}: missing {missing}, extra {extra}")
    return flat


def params_from_reference(params, cfg, *, device):
    """The port's model (``get_api(cfg).init``'s module, of any family)
    holding the JAX package's weights.

    ``params`` is the reference's parameter tree as nested dicts of
    numpy arrays (``jax.tree.map(np.asarray, params)``); ``cfg`` the
    port's (or the reference's) ``ModelConfig``.  The groups the
    reference stacks over a leading layer axis (``blocks``, ``pairs``,
    ``mamba``, ``enc``, ``dec``: an ``nn.ModuleList`` in the port) are
    split over it: the path ``("blocks", "attn", "wq")[l]`` fills
    the port's ``blocks.{l}.attn.wq``; the rest (the hybrid's one
    ``shared`` block, embeddings, norms) maps key for key.  A missing
    key, an extra key, a group not stacked over the port's count or a
    shape that differs from the port's raises ``ValueError``; values are
    kept exactly, in the port's ``cfg.dtype``.  ``device`` follows the
    device rule (None: the CUDA card)."""
    cfg = from_reference(cfg)
    device = resolve_device(device)
    model = get_api(cfg).init(cfg, None, "meta")
    flat = _port_keys(params, model, cfg)
    state = {}
    for key, ref in model.state_dict().items():
        got = _tensor(flat[key])
        if tuple(got.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: reference shape {tuple(got.shape)}, "
                             f"the port's {tuple(ref.shape)}")
        state[key] = got.to(device=device, dtype=ref.dtype)
    model.load_state_dict(state, strict=True, assign=True)
    return model


def opt_state_from_reference(opt_state, model, cfg, *, device):
    """The port's ``AdamWState`` for ``model`` holding the JAX package's
    ``AdamWState``, given as numpy: ``mu`` and ``nu`` as nested dicts of
    arrays shaped like the reference's parameters, ``step`` a scalar
    (``jax.tree.map(np.asarray, state)``, or a dict of those three).
    The moments are split over the stacked groups as
    :func:`params_from_reference` splits the weights and kept exactly in
    f32; a key or shape that does not match ``model`` raises
    ``ValueError``."""
    from .optim import AdamWState
    cfg = from_reference(cfg)
    device = resolve_device(device)
    get = (opt_state.get if isinstance(opt_state, dict)
           else lambda k: getattr(opt_state, k))
    params = dict(model.named_parameters())
    moments = []
    for tree in (get("mu"), get("nu")):
        flat = _port_keys(tree, model, cfg)
        out = {}
        for name, p in params.items():
            arr = np.asarray(flat[name], np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: reference moment shape "
                                 f"{arr.shape}, the port's {tuple(p.shape)}")
            out[name] = torch.from_numpy(arr.copy()).to(device)
        moments.append(out)
    step = torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32,
                        device=device)
    return AdamWState(mu=moments[0], nu=moments[1], step=step)
