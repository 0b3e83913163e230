"""The port's data pipeline (``repro_torch.data``) against ``repro.data``.

The port keeps a copy of the reference's numpy module, so every batch must
be byte-equal to the reference's: text, vision and encdec configs, whole
and sharded 4 ways, and the prefetch loader's order.  The twins of the
reference's own data tests (``tests/substrate/test_substrates.py``) run on
the port's copy; ``test_data_tokens_in_vocab``, a property test there, is a
parametrised one here.
"""

import inspect

import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import PrefetchLoader as JPrefetchLoader
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.data import pipeline as jpipeline
from repro_torch.configs import get_config
from repro_torch.data import (EOS, DataConfig, PrefetchLoader,
                              SyntheticDataset)
from repro_torch.data import pipeline

#: (arch, seq_len, global batch) of the trainer's data for three frontends
FRONTENDS = (("phi4-mini-3.8b", 64, 8), ("llava-next-mistral-7b", 32, 4),
             ("seamless-m4t-medium", 32, 4))


def _data_kwargs(arch, seq, batch, seed=0):
    cfg = get_config(arch, smoke=True)
    return dict(vocab_size=cfg.padded_vocab, seq_len=seq, global_batch=batch,
                seed=seed, mean_doc_len=max(seq // 8, 8),
                frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
                d_model=cfg.d_model, enc_frames_ratio=cfg.enc_frames_ratio)


def _same_bytes(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_module_is_the_references_code():
    """Below the docstring, the port's module is the reference's, line for
    line."""
    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index('"""', 3) + 3:]
    assert body(pipeline) == body(jpipeline)
    assert EOS == jpipeline.EOS


@pytest.mark.parametrize("arch,seq,batch", FRONTENDS)
@pytest.mark.parametrize("step", [0, 7, 1000])
@pytest.mark.parametrize("shards", [1, 4])
def test_batches_are_byte_equal(arch, seq, batch, step, shards):
    kw = _data_kwargs(arch, seq, batch, seed=step % 5)
    for shard in range(shards):
        got = SyntheticDataset(DataConfig(**kw), shard, shards).batch_at(step)
        want = JSyntheticDataset(JDataConfig(**kw), shard,
                                 shards).batch_at(step)
        assert got.step == want.step == step
        _same_bytes(got.data, want.data)


def test_loader_order_and_batches_equal_the_references():
    kw = _data_kwargs("llava-next-mistral-7b", 32, 4)
    loader = PrefetchLoader(SyntheticDataset(DataConfig(**kw)), start_step=3)
    jloader = JPrefetchLoader(JSyntheticDataset(JDataConfig(**kw)),
                              start_step=3)
    try:
        got = [next(loader) for _ in range(4)]
        want = [next(jloader) for _ in range(4)]
    finally:
        loader.close()
        jloader.close()
    assert not loader._thread.is_alive() and not jloader._thread.is_alive()
    assert [b.step for b in got] == [b.step for b in want] == [3, 4, 5, 6]
    for g, w in zip(got, want):
        _same_bytes(g.data, w.data)


# ---- twins of tests/substrate/test_substrates.py's data tests ----------------

def test_data_deterministic_replay():
    cfg = DataConfig(vocab_size=512, seq_len=64, global_batch=8)
    a = SyntheticDataset(cfg).batch_at(7)
    b = SyntheticDataset(cfg).batch_at(7)
    np.testing.assert_array_equal(a.data["tokens"], b.data["tokens"])
    c = SyntheticDataset(cfg).batch_at(8)
    assert not np.array_equal(a.data["tokens"], c.data["tokens"])


def test_data_sharding_partitions_global_batch():
    cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=8)
    whole = SyntheticDataset(cfg).batch_at(3).data["tokens"]
    parts = [SyntheticDataset(cfg, shard=s, num_shards=4).batch_at(3)
             .data["tokens"] for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_data_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=2)
    b = SyntheticDataset(cfg).batch_at(0)
    np.testing.assert_array_equal(b.data["labels"][:, :-1],
                                  b.data["tokens"][:, 1:])


def test_data_packing_has_eos():
    cfg = DataConfig(vocab_size=512, seq_len=2048, global_batch=2,
                     mean_doc_len=128)
    b = SyntheticDataset(cfg).batch_at(0)
    assert (b.data["tokens"] == 1).sum() > 0


def test_prefetch_loader_ordering():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=2)
    loader = PrefetchLoader(SyntheticDataset(cfg), start_step=5)
    batches = [next(loader) for _ in range(3)]
    loader.close()
    assert [b.step for b in batches] == [5, 6, 7]


@pytest.mark.parametrize("step", [0, 1, 17, 999])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_data_tokens_in_vocab(step, shards):
    cfg = DataConfig(vocab_size=97, seq_len=32, global_batch=8)
    b = SyntheticDataset(cfg, shard=0, num_shards=shards).batch_at(step)
    assert b.data["tokens"].min() >= 1
    assert b.data["tokens"].max() < 97


def test_data_rejects_nondivisible_shards():
    cfg = DataConfig(vocab_size=97, seq_len=32, global_batch=8)
    with pytest.raises(ValueError):
        SyntheticDataset(cfg, shard=0, num_shards=3)
