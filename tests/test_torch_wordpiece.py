"""The port's native WordPiece encoder (crvqa_tpu_torch/native/
wordpiece.{cpp,py}) behind `WordPieceTokenizer.raw_ids_batch`, `__call__`
and `vqacp.tokenize_questions`, against the JAX package's native encoder
and the port's own Python path, on questions that mix ASCII rows (the
native path), non-ASCII rows (accents, CJK: the Python path), a NUL, and
glued and spaced special tokens: every row's ids are equal on all three.
A vocab whose ids are not 0..n-1 takes the Python path; a library that
does not build raises."""
import numpy as np
import pytest

from crvqa_tpu.data import tokenization as jtok
from crvqa_tpu.data import vqacp as jvqacp
from crvqa_tpu_torch.data import tokenization as ttok
from crvqa_tpu_torch.data import vqacp as tvqacp
from crvqa_tpu_torch.native import wordpiece
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

WORDS = ["what", "color", "is", "the", "dog", "how", "many", "cats", "are",
         "there", "cafe", "a", "red", "ball", "?", ",", "'", "s", "n", "t"]
QUESTIONS = [
    "What color is the dog?", "How many cats are there?",
    "is the dog's ball red , or blue?", "  WHAT\tcolor\nis it  ",
    "Café au lait?", "what is 中文 here", "nul\x00inside", "",
    "the dog [SEP] the cat", "the dog[SEP]", "[CLS] what [MASK]",
    "xyzzy unknownword!!", "manycats" * 40,
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    vocab = jtok.toy_vocab(WORDS)
    path.write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    return path


def test_ids_equal_the_jax_native_encoder_and_the_python_path(vocab_file):
    port = ttok.WordPieceTokenizer(str(vocab_file))
    python = ttok.WordPieceTokenizer(str(vocab_file), native=False)
    jax_native = jtok.WordPieceTokenizer(vocab_file=str(vocab_file))
    assert port._native_handle() and jax_native._native_handle()
    native_rows = port._native_handle().encode_batch(QUESTIONS)
    # the split: ASCII rows native, the others (and a NUL) Python
    assert [r is None for r in native_rows] == [
        any(ord(c) > 127 for c in q) or "\x00" in q for q in QUESTIONS]
    for cap in (14, 512):
        got = port.raw_ids_batch(QUESTIONS, cap=cap)
        assert got == jax_native.raw_ids_batch(QUESTIONS, cap=cap)
        assert got == python.raw_ids_batch(QUESTIONS, cap=cap)
    assert port(QUESTIONS, max_length=20) == jax_native(QUESTIONS,
                                                         max_length=20)
    ids, lengths = tvqacp.tokenize_questions(QUESTIONS, port)
    jids, jlengths = jvqacp.tokenize_questions(QUESTIONS, jax_native)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(lengths, jlengths)


def test_a_vocab_without_dense_ids_takes_the_python_path(tmp_path,
                                                         vocab_file):
    lines = vocab_file.read_text().splitlines()
    dup = tmp_path / "vocab.txt"
    dup.write_text("\n".join(lines + [lines[-1]]) + "\n")  # a repeated line
    tok = ttok.WordPieceTokenizer(str(dup))
    assert not wordpiece.dense_ids(tok.vocab) and tok._native is False
    python = ttok.WordPieceTokenizer(str(dup), native=False)
    assert tok.raw_ids_batch(QUESTIONS) == python.raw_ids_batch(QUESTIONS)


def test_a_failed_build_raises(tmp_path, monkeypatch, vocab_file):
    bad = tmp_path / "wordpiece.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(wordpiece, "_SRC", str(bad))
    monkeypatch.setattr(wordpiece, "_LIB_NAME", "libwordpiece_broken.so")
    monkeypatch.setattr(wordpiece, "_lib", None)
    tok = ttok.WordPieceTokenizer(str(vocab_file))
    with pytest.raises(RuntimeError, match="libwordpiece_broken.so"):
        tok.raw_ids_batch(["what color"])
