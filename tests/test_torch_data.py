"""repro_torch.data.pipeline, a numpy copy of repro.data.pipeline: the
same (config, step, host) gives the same batch, bit for bit."""
import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import host_batch as jax_host_batch

from repro_torch.data import DataConfig, Prefetcher, host_batch

CONFIGS = [dict(vocab_size=100, seq_len=16, global_batch=4),
           dict(vocab_size=128256, seq_len=64, global_batch=2, seed=3),
           dict(vocab_size=256, seq_len=33, global_batch=8, repeat_p=0.8,
                zipf_a=1.5)]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("step", [0, 7, 1000])
def test_host_batch_equals_reference(kw, step):
    want = jax_host_batch(JData(**kw), step)
    got = host_batch(DataConfig(**kw), step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        assert np.array_equal(got[k], want[k])


def test_host_shards_equal_reference():
    kw = CONFIGS[2]
    for host in range(2):
        want = jax_host_batch(JData(**kw), 3, host_index=host, num_hosts=2)
        got = host_batch(DataConfig(**kw), 3, host_index=host, num_hosts=2)
        assert got["tokens"].shape == (4, 33)
        assert np.array_equal(got["tokens"], want["tokens"])
        assert np.array_equal(got["labels"], want["labels"])


def test_prefetcher_delivers_in_order():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=2)
    pf = Prefetcher(cfg, start_step=5)
    try:
        s0, b0 = pf.next()
        s1, _ = pf.next()
        assert (s0, s1) == (5, 6)
        assert np.array_equal(b0["tokens"], host_batch(cfg, 5)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
