"""The port's token pipeline (``repro_torch.data``) against the
reference's: the same seeded batches, bit for bit, for every family's
inputs, and the prefetching iterator."""
import numpy as np
import pytest

from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import RunShape as RefRunShape
from repro.data import make_batch_fn as ref_make_batch_fn
from repro_torch.configs import smoke_config
from repro_torch.configs.base import RunShape
from repro_torch.data import TokenPipeline, make_batch_fn


@pytest.mark.parametrize("arch", ["olmo-1b", "paligemma-3b",
                                  "seamless-m4t-large-v2", "jamba-v0.1-52b"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_the_reference(arch, seed):
    fn = make_batch_fn(smoke_config(arch), RunShape("t", 16, 2, "train"),
                       seed=seed)
    ref = ref_make_batch_fn(ref_smoke_config(arch),
                            RefRunShape("t", 16, 2, "train"), seed=seed)
    for step in (0, 5, 123_456):
        got, want = fn(step), ref(step)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_pipeline_deterministic_and_prefetches():
    fn = make_batch_fn(smoke_config("olmo-1b"), RunShape("t", 16, 2, "train"),
                       seed=7)
    np.testing.assert_array_equal(fn(5)["tokens"], fn(5)["tokens"])
    pipe = TokenPipeline(fn, depth=2)
    got = list(pipe.iter(3, 8))
    assert [s for s, _ in got] == list(range(3, 8))
    for s, batch in got:
        np.testing.assert_array_equal(batch["tokens"], fn(s)["tokens"])
    # a consumer that stops early ends the iteration cleanly
    it = pipe.iter(0, 100)
    assert next(it)[0] == 0
    it.close()
