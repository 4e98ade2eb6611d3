"""The port's N:M packing (``repro_torch.sparsity.nm``) against the JAX
package's, bit for bit.

The same numpy input goes through both packages for all five (n, m)
patterns the kernels take, in f32 and bf16, with inputs that have
repeated magnitudes, zeros and negative zeros (the tie-breaking and
signed-zero cases).  Every output — pruned W, packed values, int8
offsets, bit-packed offsets, unpacked offsets and the dense unpacking —
must be identical down to the bit pattern, and so must its dtype."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.sparsity import nm as ref  # noqa: E402
from repro_torch.sparsity import nm  # noqa: E402

PAIRS = [(2, 4), (1, 4), (2, 6), (2, 8), (4, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _weights(kind: str, K: int, N: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(K, N)).astype(np.float32)
    if kind == "ties":          # few distinct magnitudes, both signs
        return rng.integers(-2, 3, size=(K, N)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    w[rng.random((K, N)) < 0.6] = 0.0
    w[rng.random((K, N)) < 0.2] = -0.0
    return w


def _bits(x) -> np.ndarray:
    """Bit patterns (floats widened to f32 first, exactly)."""
    if isinstance(x, torch.Tensor):
        x = (x.float() if x.is_floating_point() else x).numpy()
    else:
        x = np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
            x.dtype, jnp.floating) else x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _same(got, want) -> None:
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("n,m", PAIRS)
def test_nm_bit_identical_to_reference(n, m, kind, dtype):
    jdt, tdt = DTYPES[dtype]
    w = _weights(kind, 12 * m, 40, seed=10 * n + m)
    jw = jnp.asarray(w, jdt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt)

    want_p, got_p = ref.nm_prune_dense(jw, n, m), nm.nm_prune_dense(tw, n, m)
    _same(got_p, want_p)
    want_v, want_i = ref.pack_nm(want_p, n, m)
    got_v, got_i = nm.pack_nm(got_p, n, m)
    _same(got_v, want_v)
    _same(got_i, want_i)
    want_k, got_k = ref.pack_offsets(want_i, m), nm.pack_offsets(got_i, m)
    _same(got_k, want_k)
    rows = want_i.shape[0]
    _same(nm.unpack_offsets(got_k, m, rows),
          ref.unpack_offsets(want_k, m, rows))
    _same(nm.unpack_nm_with(got_v, got_i, n, m),
          ref.unpack_nm_with(want_v, want_i, n, m))
    # N:M structure: at most n nonzeros in every m-block of every column
    nz = (got_p.float().reshape(-1, m, 40) != 0).sum(dim=1)
    assert int(nz.max()) <= n
    # packing the unpruned W too (more than n nonzeros per block)
    _same(nm.pack_nm(tw, n, m)[1], ref.pack_nm(jw, n, m)[1])


@pytest.mark.parametrize("m", [2, 3, 4, 5, 6, 7, 8, 16])
def test_offsets_bits_and_layout(m):
    assert nm.offsets_bits(m) == ref.offsets_bits(m)
    bits = nm.offsets_bits(m)
    per = 8 // bits
    idx = torch.arange(per, dtype=torch.int8).remainder(m)[:, None]
    byte = int(nm.pack_offsets(idx, m)[0, 0])
    # row r sits at bit (r % per) * bits of its byte
    assert byte == sum(int(idx[r, 0]) << (r * bits) for r in range(per))


def test_unpack_nm_raises_and_bad_rows_raise():
    with pytest.raises(NotImplementedError):
        nm.unpack_nm(torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int8))
    with pytest.raises(ValueError, match="offsets/byte"):
        nm.pack_offsets(torch.zeros(6, 4, dtype=torch.int8), 4)
    with pytest.raises(ValueError, match="not divisible"):
        nm.nm_prune_dense(torch.zeros(6, 4), 2, 4)
