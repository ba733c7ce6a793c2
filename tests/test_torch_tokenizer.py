"""The port's Qwen2 tokenizer against the JAX reference's: the hand-written
pre-tokenizer splits as the ``regex`` package's pattern does, and ids and
decoded text are equal, on a corpus with non-ASCII letters and digits, CJK,
emoji, ``\\r\\n``, runs of spaces before words, contractions and the special
tokens."""

import json

import numpy as np
import pytest

from tstar_tpu.models import qwen_tokenizer as jtok
from tstar_tpu_torch.models import qwen_tokenizer as ttok

CORPUS = [
    "Hello world! It's a test, isn't it? We'll see; they'd've done it.",
    "I'M HERE. You'RE there, we'VE been, she'LL go, he'D know, it'S, don'T",
    "Straße naïve café Ελληνικά русский العربية हिन्दी ٣٤٥ ๑๒๓ ½ ² Ⅻ",
    "中文字符测试，日本語のテキスト、한국어 텍스트。",
    "emoji 🎉🎉 👍🏽 family 👨‍👩‍👧 flags 🇫🇷",
    "line one\r\nline two\n\n\nthree\r\rfour\n \n  five",
    "    four spaces before\tand\ttabs\t\t\tand   nbsp　ideographic",
    "trailing spaces   ",
    "   ",
    "12345 3.14159 -42 1e10 0x1F",
    "punct!!! ??? ... --- *** (parens) [brackets] {braces} \"quotes\" 'single'",
    " !leading space punct\n\n",
    "'s's 'S 'ſ 'll'LL 'x 'abc",
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\nQ?<|im_end|>",
    "<|vision_start|><|image_pad|><|image_pad|><|vision_end|>tail",
    "mixed\x1ccontrol\x1fchars\x0bvt\x0cff\x85nel",
    "a b c",
    "",
    "x",
    "9a a9 _under_score_ camelCase ALLCAPS",
]


@pytest.mark.parametrize("text", CORPUS)
def test_pretokenize_matches_regex(text):
    assert ttok.pretokenize(text) == jtok._PRETOKENIZE.findall(text)


def test_pretokenize_matches_regex_on_random_text():
    """Random strings over a pool that mixes every class the pattern tells
    apart: letters, numbers, white space of each kind, apostrophes,
    punctuation, marks."""
    pool = list("aZé中ß'sStTdDlLmMrReEvV ") + ["\n", "\r", "\t", " ", "　", "\x1c", "5", "٣",
                                              "!", "-", "'", "😀", "́", "_", "ſ", "  "]
    rng = np.random.default_rng(0)
    for _ in range(400):
        text = "".join(rng.choice(pool, size=rng.integers(1, 30)))
        assert ttok.pretokenize(text) == jtok._PRETOKENIZE.findall(text), repr(text)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """A byte-level vocabulary with merges over the corpus's frequent pairs
    (so BPE merges run), as a checkpoint ships it."""
    d = tmp_path_factory.mktemp("qwen_vocab")
    b2u = jtok._bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for a, b in [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"), ("Ġ", "a"),
                 ("l", "l"), ("o", "n"), ("Ġ", "s"), ("ä", "¸"), ("Ċ", "Ċ"), ("Ġ", "Ġ")]:
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab))
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(d)


def test_ids_and_text_match_reference(vocab_dir):
    jt = jtok.QwenTokenizer.from_dir(vocab_dir)
    tt = ttok.QwenTokenizer.from_dir(vocab_dir)
    assert tt.eos_id == jt.eos_id and tt.pad_id == jt.pad_id
    for text in CORPUS:
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        for skip in (True, False):
            assert tt.decode(ids, skip_special=skip) == jt.decode(ids, skip_special=skip)
    ids = tt.encode(CORPUS[13])
    assert ids[0] == ttok.SPECIAL_TOKENS["<|im_start|>"]
    assert tt.decode(ids + [999_999]) == jt.decode(ids + [999_999])   # unknown id -> ""


def test_special_tokens_from_tokenizer_config(vocab_dir, tmp_path):
    """``tokenizer_config.json``'s ``added_tokens_decoder`` replaces the
    default special ids, in both packages."""
    import shutil

    for f in ("vocab.json", "merges.txt"):
        shutil.copy(f"{vocab_dir}/{f}", tmp_path / f)
    added = {str(300 + i): {"content": t} for i, t in enumerate(ttok.SPECIAL_TOKENS)}
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"added_tokens_decoder": added}))
    tt, jt = ttok.QwenTokenizer.from_dir(str(tmp_path)), jtok.QwenTokenizer.from_dir(str(tmp_path))
    assert tt.special == jt.special and tt.eos_id == 302
    assert tt.encode(CORPUS[13]) == jt.encode(CORPUS[13])
