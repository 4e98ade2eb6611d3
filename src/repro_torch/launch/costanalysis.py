"""Per-rank cost count of one step: the counterpart of the JAX package's
``launch/hloanalysis.py``.

The reference parses the HLO that XLA compiled for one device and adds
up, through the call graph and each ``while`` loop's trip count, the
matmul FLOPs, the bytes of every dot's operands and result (its proxy
for HBM traffic) and the bytes of every collective by kind.  The port
has no HLO: its step runs eagerly, so :class:`CostMode` watches the ops
themselves as they dispatch and keeps the same record,
:class:`HloCosts`, which ``roofline.py`` reads as the reference's reads
its own.

* It counts **per rank**.  A DTensor op is let through (the mode
  returns ``NotImplemented`` for it), DTensor runs it on this rank's
  shard, and the local ops that come back are counted: the FLOPs of
  ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (2 per multiply-add) and K4's
  registered operator (its formula, ``flash_attention_flops``), and
  their operand and result bytes; a convolution's FLOPs as the
  reference counts them (2 x its output's elements).
* Collective bytes are the output bytes of each ``_c10d_functional``
  collective that DTensor issues, by the reference's kind names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``).
  On a CPU mesh, as the dry run's, DTensor moves a split from one
  dimension to another with an all-gather and a chunk where a CUDA mesh
  runs an all-to-all; that all-gather is counted as the all-to-all.
* There is no trip count: each layer runs once per execution, and each
  op is seen each time it runs, which is what the reference's
  scan-aware multiply reconstructs.
* DTensor learns an op's output shape by running it once on fake
  tensors of the global shapes; those runs are not counted.
* With ``track_memory`` it follows the local tensors this rank
  allocates: each new storage is live until Python frees it, so
  ``peak_temp_bytes`` is the most that was live at once beyond the
  storages given to :meth:`CostMode.exclude` (the arguments).

The HLO text parser has no counterpart: the port has no HLO.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
#: the dots: their FLOPs and their operand and result bytes are counted
_DOTS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
         aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}
_CONV = (aten.convolution.default,)
#: ``_c10d_functional`` collective -> the reference's kind name
_KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "broadcast": "collective-permute"}


@dataclasses.dataclass
class HloCosts:
    """The reference's record (``hloanalysis.HloCosts``), per rank, plus
    ``by_op``: FLOPs and dot bytes by op name, so that a part (say the
    attention products) can be taken out."""
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    collective_count: float = 0.0
    by_op: dict[str, list[float]] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: [0.0, 0.0]))
    peak_temp_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def without(self, *ops: str) -> tuple[float, float]:
        """(dot FLOPs, dot bytes) with the ops named taken out."""
        f = self.dot_flops - sum(self.by_op[o][0] for o in ops
                                 if o in self.by_op)
        b = self.dot_bytes - sum(self.by_op[o][1] for o in ops
                                 if o in self.by_op)
        return f, b


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _op_name(func) -> str:
    return func.overloadpacket.__name__


def _in_alltoall_fallback(depth: int = 16) -> bool:
    """Whether DTensor's ``shard_dim_alltoall`` is on the stack."""
    f = sys._getframe(1)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


class CostMode(TorchDispatchMode):
    """Counts the local ops of everything run inside ``with CostMode()
    as cm:`` into ``cm.costs`` (:class:`HloCosts`)."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.costs = HloCosts()
        self.track_memory = track_memory
        self._live: dict[int, int] = {}
        self._excluded: set[int] = set()
        self._now = 0

    def exclude(self, tensors) -> int:
        """Take the storages of ``tensors`` (their local shards) out of
        the memory count; returns their bytes, each storage once."""
        total = 0
        for t in tensors:
            t = getattr(t, "_local_tensor", t)
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            if key not in self._excluded:
                self._excluded.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def _track(self, out) -> None:
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._excluded:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._now += n
            self.costs.peak_temp_bytes = max(self.costs.peak_temp_bytes,
                                             self._now)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self._now -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented       # let DTensor run it per shard
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation runs the op on global-shape
            # fake tensors to learn the output's shape: not this rank's
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        c = self.costs
        ns = func.namespace
        if func in _DOTS or (ns == "repro_torch"
                             and func.overloadpacket in flop_registry):
            flops = flop_registry[func.overloadpacket](*args, out_val=out,
                                                       **kwargs)
            nb = _nbytes(out)
            if func in _DOTS:
                nb += sum(_nbytes(args[i]) for i in _DOTS[func])
            else:
                nb += sum(_nbytes(a) for a in args)
            c.dot_flops += flops
            c.dot_bytes += nb
            entry = c.by_op[_op_name(func)]
            entry[0] += flops
            entry[1] += nb
        elif func in _CONV:
            c.dot_flops += 2.0 * out.numel()
            c.by_op["convolution"][0] += 2.0 * out.numel()
        elif ns == "_c10d_functional" and _op_name(func) in _KINDS:
            kind = _KINDS[_op_name(func)]
            nb = sum(_nbytes(t) for t in (
                out if isinstance(out, (tuple, list)) else (out,)))
            if kind == "all-gather" and _in_alltoall_fallback():
                # a CPU mesh's Shard(i) -> Shard(j) all-to-all, done as an
                # all-gather and a chunk: count the all-to-all a CUDA mesh
                # runs, whose output is as large as its input
                kind, nb = "all-to-all", _nbytes(args[0])
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + nb
            c.collective_count += 1
        if self.track_memory:
            self._track(out)
        return out


def analyze(fn, *args, track_memory: bool = False, **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`HloCosts`)."""
    with CostMode(track_memory=track_memory) as cm:
        out = fn(*args, **kwargs)
    return out, cm.costs
