"""The port's synthetic pipeline (``repro_torch.data.pipeline``) against the
reference's, on the CPU: the draws are numpy's ``default_rng`` in the
reference's order, so tokens, labels and embeddings are equal (not close)
for full batches and for host slices, in tokens and embeddings mode."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro_torch.data.pipeline import DataConfig, SyntheticLM

CASES = [dict(seed=0, global_batch=4, seq_len=32, vocab_size=512),
         dict(seed=3, global_batch=8, seq_len=17, vocab_size=151),
         dict(seed=1, global_batch=4, seq_len=16, vocab_size=64,
              input_mode="embeddings", d_model=24)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("step", [0, 5, 123456])
def test_batches_equal_the_reference(case, step):
    ref = RefSyntheticLM(RefDataConfig(**case))
    mine = SyntheticLM(DataConfig(**case))
    np.testing.assert_array_equal(mine.bigram, ref.bigram)
    b = case["global_batch"]
    for start, count in ((0, None), (0, b // 2), (b // 2, b // 2), (1, 2)):
        want = ref.batch_at(step, start, count)
        got = mine.batch_at(step, start, count, device="cpu")
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device.type == "cpu"
            assert v.dtype == (torch.float32 if k == "embeds"
                               else torch.int32)
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def test_iterate_and_host_slices_compose():
    data = SyntheticLM(DataConfig(global_batch=6, seq_len=12))
    it = data.iterate(start_step=4, device="cpu")
    for step in (4, 5):
        s, batch = next(it)
        assert s == step
        whole = data.host_batch_at(step)
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      whole["tokens"])
        parts = [data.host_batch_at(step, i, 2)["tokens"] for i in (0, 2, 4)]
        np.testing.assert_array_equal(np.concatenate(parts), whole["tokens"])
        np.testing.assert_array_equal(whole["labels"],
                                      np.roll(whole["tokens"], -1, axis=1))
