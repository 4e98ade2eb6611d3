"""Workload specification: extended-Einsum tensor algebra problems.

A workload is described the way Sparseloop (Sec. 5.1) describes it:

  * a set of named *ranks* (iteration-space dimensions) with integer bounds,
  * a set of tensors, each *projecting* a subset of ranks onto its data-space
    dimensions (affine, coefficient-1 sums for sliding windows, e.g.
    ``Input[n, c, p+r, q+s]`` for convolution),
  * exactly one output tensor; ranks absent from the output projection are
    *reduction* ranks,
  * per-tensor statistical density specifications (Sec. 5.3.2).

Examples
--------
Matrix multiplication  Z[m,n] = sum_k A[m,k] * B[k,n]::

    matmul(M, K, N, densities={"A": ("uniform", 0.25)})

Conv2D  O[n,k,p,q] = sum_{c,r,s} I[n,c,p+r,q+s] * W[k,c,r,s]::

    conv2d(N=1, K=64, C=64, P=56, Q=56, R=3, S=3)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

# A data-space dimension is a tuple of rank names that are summed
# (coefficient-1 affine projection).  ("p", "r") means the dim is p + r.
Projection = tuple[tuple[str, ...], ...]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One tensor of the Einsum: name + projection from ranks to dims."""

    name: str
    projection: Projection

    @property
    def ranks(self) -> frozenset[str]:
        return frozenset(r for dim in self.projection for r in dim)

    def dim_sizes(self, rank_bounds: Mapping[str, int]) -> tuple[int, ...]:
        """Data-space extents. A summed dim (p+r) has extent P + R - 1."""
        return tuple(
            sum(rank_bounds[r] for r in dim) - (len(dim) - 1)
            for dim in self.projection
        )

    def size(self, rank_bounds: Mapping[str, int]) -> int:
        return math.prod(self.dim_sizes(rank_bounds))

    def tile_dims(self, tile_bounds: Mapping[str, int]) -> tuple[int, ...]:
        """Extents of the tile induced by per-rank tile bounds (with halo)."""
        return tuple(
            sum(tile_bounds.get(r, 1) for r in dim) - (len(dim) - 1)
            for dim in self.projection
        )

    def tile_size(self, tile_bounds: Mapping[str, int]) -> int:
        return math.prod(self.tile_dims(tile_bounds))


@dataclasses.dataclass(frozen=True)
class Workload:
    """An extended-Einsum workload with statistical density annotations."""

    name: str
    rank_bounds: dict[str, int]
    tensors: tuple[TensorSpec, ...]
    output: str
    # tensor name -> density spec, e.g. ("uniform", 0.25) or
    # ("structured", {"n": 2, "m": 4}) or
    # ("banded", {"rows", "cols", "half_band"}) or
    # ("causal", {"rows", "cols", "window"}): (i, j) nonzero iff
    # i - window < j <= i, or ("causal_topk", {"rows", "cols", "window",
    # "k"}): min(k, n_i) of row i's n_i causal entries, drawn uniformly,
    # or ("causal_block_topk", {"rows", "cols", "block", "k", "init",
    # "local"}): row i's causal columns in blocks of ``block``, its first
    # init and last local blocks and min(k, n_i) of its n_i other blocks,
    # drawn uniformly, or ("actual", np.ndarray).  Missing tensors are
    # dense.
    densities: dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        names = [t.name for t in self.tensors]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tensor names in {names}")
        if self.output not in names:
            raise ValueError(f"output {self.output!r} not among {names}")
        for t in self.tensors:
            for dim in t.projection:
                for r in dim:
                    if r not in self.rank_bounds:
                        raise ValueError(
                            f"tensor {t.name} projects unknown rank {r!r}")

    # ------------------------------------------------------------------
    @property
    def ranks(self) -> tuple[str, ...]:
        return tuple(self.rank_bounds)

    def tensor(self, name: str) -> TensorSpec:
        for t in self.tensors:
            if t.name == name:
                return t
        raise KeyError(name)

    @property
    def output_tensor(self) -> TensorSpec:
        return self.tensor(self.output)

    @property
    def input_tensors(self) -> tuple[TensorSpec, ...]:
        return tuple(t for t in self.tensors if t.name != self.output)

    @property
    def reduction_ranks(self) -> frozenset[str]:
        return frozenset(self.rank_bounds) - self.output_tensor.ranks

    @property
    def num_computes(self) -> int:
        """Dense MACs = product of all rank bounds."""
        return math.prod(self.rank_bounds.values())

    def density_spec(self, tensor: str) -> object:
        return self.densities.get(tensor, ("dense", None))


# ----------------------------------------------------------------------
# Common workload constructors
# ----------------------------------------------------------------------
def matmul(M: int, K: int, N: int, *, densities: dict | None = None,
           name: str = "matmul") -> Workload:
    """Z[m,n] = sum_k A[m,k] * B[k,n]  (the paper's running spMspM example)."""
    return Workload(
        name=name,
        rank_bounds={"m": M, "k": K, "n": N},
        tensors=(
            TensorSpec("A", (("m",), ("k",))),
            TensorSpec("B", (("k",), ("n",))),
            TensorSpec("Z", (("m",), ("n",))),
        ),
        output="Z",
        densities=dict(densities or {}),
    )


def conv2d(N: int, K: int, C: int, P: int, Q: int, R: int, S: int, *,
           densities: dict | None = None, name: str = "conv2d") -> Workload:
    """O[n,k,p,q] = sum_{c,r,s} I[n,c,p+r,q+s] * W[k,c,r,s]."""
    return Workload(
        name=name,
        rank_bounds={"n": N, "k": K, "c": C, "p": P, "q": Q, "r": R, "s": S},
        tensors=(
            TensorSpec("I", (("n",), ("c",), ("p", "r"), ("q", "s"))),
            TensorSpec("W", (("k",), ("c",), ("r",), ("s",))),
            TensorSpec("O", (("n",), ("k",), ("p",), ("q",))),
        ),
        output="O",
        densities=dict(densities or {}),
    )


def dot(K: int, *, densities: dict | None = None, name: str = "dot") -> Workload:
    """z = sum_k A[k] * B[k]  (the Fig. 3 dot-product example)."""
    return Workload(
        name=name,
        rank_bounds={"k": K},
        tensors=(
            TensorSpec("A", (("k",),)),
            TensorSpec("B", (("k",),)),
            TensorSpec("Z", ()),
        ),
        output="Z",
        densities=dict(densities or {}),
    )


def mv(M: int, K: int, *, densities: dict | None = None,
       name: str = "mv") -> Workload:
    """z[m] = sum_k A[m,k] * x[k]  (matrix-vector)."""
    return Workload(
        name=name,
        rank_bounds={"m": M, "k": K},
        tensors=(
            TensorSpec("A", (("m",), ("k",))),
            TensorSpec("B", (("k",),)),
            TensorSpec("Z", (("m",),)),
        ),
        output="Z",
        densities=dict(densities or {}),
    )
