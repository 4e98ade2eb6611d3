"""The port's synthetic data pipeline (a copy of the JAX package's numpy
module): its batches equal the reference's exactly over seeds, steps and
shards, and ``restore`` resumes the stream."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import make_pipeline as ref_make_pipeline  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataState, make_pipeline  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_batches_equal_reference(seed, num_shards):
    for shard in range(num_shards):
        ref = ref_make_pipeline(ref_get_config("qwen2-0.5b", reduced=True),
                                24, 8, seed=seed, num_shards=num_shards,
                                shard=shard)
        port = make_pipeline(get_config("qwen2-0.5b", reduced=True), 24, 8,
                             seed=seed, num_shards=num_shards, shard=shard)
        for _ in range(3):
            want, got = next(ref), next(port)
            assert got.keys() == want.keys() == {"tokens", "targets"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
        assert port.state.to_dict() == ref.state.to_dict()


def test_restore_resumes_the_stream():
    cfg = get_config("qwen2-0.5b", reduced=True)
    pipe = make_pipeline(cfg, 16, 4, seed=3)
    for _ in range(3):
        next(pipe)
    saved = pipe.state.to_dict()
    want = [next(pipe) for _ in range(2)]
    resumed = make_pipeline(cfg, 16, 4, seed=3)
    resumed.restore(DataState.from_dict(saved))
    for w in want:
        got = next(resumed)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])
    assert resumed.state.step == 5
