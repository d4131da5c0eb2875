"""The port's data pipeline and tokenizer against the JAX package's, bit
for bit: the first batches of ``synthetic_lm_batches``, ``pack_documents``,
``text_file_batches`` over a temporary file (past an epoch's end, where
the shuffle reseeds) and ``ByteTokenizer``. Both are NumPy only, so no JAX
program is compiled here."""
import itertools

import numpy as np
import pytest

from repro import data as jdata
from repro_torch import data


@pytest.mark.parametrize("shape", [(2, 16, 64, 7), (4, 32, 256, 0),
                                   (3, 9, 50, 1)],
                         ids=["b2s16v64", "b4s32v256", "b3s9v50"])
def test_synthetic_batches_equal(shape):
    b, s, v, seed = shape
    mine = data.synthetic_lm_batches(data.DataConfig(b, s, v, seed))
    ref = jdata.synthetic_lm_batches(jdata.DataConfig(b, s, v, seed))
    for got, want in itertools.islice(zip(mine, ref), 3):
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_pack_documents_equal():
    rng = np.random.default_rng(0)
    docs = [list(rng.integers(1, 300, rng.integers(1, 40)))
            for _ in range(25)]
    for seq_len, pad in ((4, 0), (16, 256), (33, 7)):
        got = data.pack_documents(docs, seq_len, pad_id=pad)
        want = jdata.pack_documents(docs, seq_len, pad_id=pad)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_text_file_batches_equal(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(
        f"line {i}: DyMoE — dynamic experts, é{'x' * (i % 17)}"
        for i in range(40)) + "\n\n  \n")
    cfg = dict(batch_size=3, seq_len=24, vocab_size=259, seed=5)
    mine = data.text_file_batches(str(path), data.DataConfig(**cfg),
                                  data.ByteTokenizer())
    ref = jdata.text_file_batches(str(path), jdata.DataConfig(**cfg),
                                  jdata.ByteTokenizer())
    # 40 lines pack into a handful of rows: 12 batches cross epochs
    for got, want in itertools.islice(zip(mine, ref), 12):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_byte_tokenizer_equal():
    mine, ref = data.ByteTokenizer(), jdata.ByteTokenizer()
    for attr in ("PAD", "BOS", "EOS", "vocab_size"):
        assert getattr(mine, attr) == getattr(ref, attr)
    for text in ("", "DyMoE: dynamic experts!", "ünïcødé — 漢字 🙂"):
        for bos, eos in itertools.product((False, True), repeat=2):
            ids = mine.encode(text, add_bos=bos, add_eos=eos)
            assert ids == ref.encode(text, add_bos=bos, add_eos=eos)
            assert mine.decode(ids) == ref.decode(ids) == text
    junk = [300, 0xE2, 0x82, 65, 257, 258]          # a cut UTF-8 sequence
    assert mine.decode(junk) == ref.decode(junk)
