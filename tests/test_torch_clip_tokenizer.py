"""The port's CLIP BPE tokenizer against the JAX package's, on the CPU.

The hand-written pre-tokenizer splits as the reference's ``regex`` pattern
does (``_TOKEN_PATTERN.findall``): on a Unicode corpus, on 400 random
strings over a pool that mixes every class the pattern tells apart, and on
every code point assigned in the running Python's Unicode tables, 7 at a
time (the ``regex`` package may know newer code points; those are not
compared).  Text cleaning (HTML unescape, NFC, whitespace collapse,
lowercase) is equal on the corpus.  Ids and padded batches are EQUAL on the
vocabulary of ``tests/test_owlvit_loader.py`` and on a byte-level one.
"""

import json
import sys
import unicodedata

import numpy as np
import pytest

from tstar_tpu.models import clip_tokenizer as jtok
from tstar_tpu_torch.models import clip_tokenizer as ttok

CORPUS = [
    "a photo of a couch",
    "Hello world! It's a test, isn't it? We'll see; they'd've done it.",
    "I'M HERE. You'RE there, we'VE been, she'LL go, he'D know, it'S, don'T",
    "Straße naïve café Ελληνικά русский العربية हिन्दी ٣٤٥ ๑๒๓ ½ ² Ⅻ",
    "中文字符测试，日本語のテキスト、한국어 텍스트。",
    "emoji 🎉🎉 👍🏽 family 👨‍👩‍👧 flags 🇫🇷",
    "line one\r\nline two\n\n\nthree\r\rfour\n \n  five",
    "    four spaces before\tand\ttabs\t\t\tand   nbsp ideographic　space",
    "<|startoftext|>red lamp<|endoftext|> <|STARTOFTEXT|> <|ſtartoftext|> <|endoftext",
    "'s's 'S 'ſ 'll'LL 'x 'abc '' ''' 're're",
    "mixed\x1ccontrol\x1fchars\x0bvt\x0cff\x85nel",
    "ypogegrammeni ͅ aͅb !ͅ! ᾀ",
    "&amp; &lt;b&gt; &amp;amp; &#39;quoted&#39;",
    "punct!!! ??? ... --- *** (parens) [brackets] {braces} \"quotes\"",
    "12345 3.14159 -42 1e10 0x1F",
    "",
    " ",
    "x",
]


@pytest.mark.parametrize("text", CORPUS)
def test_pretokenize_matches_regex(text):
    assert ttok._clean_text(text) == jtok._clean_text(text)
    assert ttok.pretokenize(text) == jtok._TOKEN_PATTERN.findall(text)
    cleaned = jtok._clean_text(text)
    assert ttok.pretokenize(cleaned) == jtok._TOKEN_PATTERN.findall(cleaned)


def test_pretokenize_matches_regex_on_random_text():
    pool = list("aZé中ß'sStTdDlLmMrReEvV <|>!") + [
        "\n", "　", "\x1c", "5", "٣", "ͅ", "ſ", "́", "😀", "<|startoftext|>",
        "<|endoftext|>", "&amp;", "  ", "\t"]
    rng = np.random.default_rng(0)
    for _ in range(400):
        text = "".join(rng.choice(pool, size=rng.integers(1, 30)))
        assert ttok.pretokenize(text) == jtok._TOKEN_PATTERN.findall(text), repr(text)
        assert ttok._clean_text(text) == jtok._clean_text(text), repr(text)


def test_pretokenize_matches_regex_on_every_assigned_code_point():
    chars = [chr(c) for c in range(sys.maxunicode + 1)
             if not 0xD800 <= c < 0xE000 and unicodedata.category(chr(c)) != "Cn"]
    assert len(chars) > 140_000
    for i in range(0, len(chars), 7):
        text = "".join(chars[i:i + 7])
        assert ttok.pretokenize(text) == jtok._TOKEN_PATTERN.findall(text), repr(text)


def _write(d, vocab, merges):
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return str(d)


@pytest.fixture(scope="module")
def letters_vocab(tmp_path_factory):
    """The CLIP-style vocabulary of ``tests/test_owlvit_loader.py``."""
    chars = list("abcdefghijklmnopqrstuvwxyz ")
    vocab = {}
    for ch in chars:
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    merges = [("c", "o"), ("co", "u"), ("cou", "c"), ("couc", "h</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return _write(tmp_path_factory.mktemp("clip_letters"), vocab, merges)


@pytest.fixture(scope="module")
def byte_vocab(tmp_path_factory):
    """Every byte alone and as a word end, and merges over frequent pairs."""
    b2u = jtok._bytes_to_unicode()
    vocab = {}
    for b in range(256):
        vocab.setdefault(b2u[b], len(vocab))
        vocab.setdefault(b2u[b] + "</w>", len(vocab))
    merges = [("t", "h"), ("th", "e</w>"), ("c", "o"), ("co", "u"), ("l", "a"), ("la", "m"),
              ("i", "n"), ("Ã", "©"), ("'", "s</w>"), ("r", "e")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return _write(tmp_path_factory.mktemp("clip_bytes"), vocab, merges)


@pytest.mark.parametrize("context", [16, 8])
def test_ids_match_reference_letters(letters_vocab, context):
    jt = jtok.ClipTokenizer.from_dir(letters_vocab, context=context)
    tt = ttok.ClipTokenizer.from_dir(letters_vocab, context=context)
    texts = ["couch", "a couch by the lamp", "  Couch  ", "", "a b c d e f g h i j k l m"]
    for t in texts:
        assert tt.encode(t) == jt.encode(t), t
    for got, want in zip(tt.encode_batch(texts), jt.encode_batch(texts)):
        np.testing.assert_array_equal(got, want)
    assert (tt.bos_id, tt.eos_id, tt.pad_id) == (jt.bos_id, jt.eos_id, jt.pad_id)


def test_ids_match_reference_bytes(byte_vocab):
    jt = jtok.ClipTokenizer.from_dir(byte_vocab, context=77)
    tt = ttok.ClipTokenizer.from_dir(byte_vocab, context=77)
    for t in CORPUS:
        assert tt.tokenize(t) == jt.tokenize(t), t
        assert tt.encode(t) == jt.encode(t), t
    for got, want in zip(tt.encode_batch(CORPUS), jt.encode_batch(CORPUS)):
        np.testing.assert_array_equal(got, want)


def test_hash_tokenizer_unchanged():
    texts = ["couch", "floor lamp", " "]
    for got, want in zip(ttok.HashTokenizer(100, 8).encode_batch(texts),
                         jtok.HashTokenizer(100, 8).encode_batch(texts)):
        np.testing.assert_array_equal(got, want)
