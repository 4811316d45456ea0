"""The port's byte-level BPE tokenizer (``ssp_x_vit_tpu_torch/llm/tokenizer.py``)
against the JAX package's ``ByteLevelBPETokenizer`` on the committed
``ckpts/code_llm_small/tokenizer.json`` (8191 base tokens, 7935 merges, the
added ``<|endoftext|>`` = 8191), on the CPU.

- all of ``corpus_slice/val.bin`` decoded and encoded again: the committed ids
  without the 39 ``<|endoftext|>``, exactly as the JAX tokenizer gives them;
- ``decode`` of every id; hypothesis text over the code points Unicode 15.0
  assigns, with the classes where ``re`` and ``unicodedata`` mislead named
  (U+001C-U+001F, ``²``, ``½``, CJK, combining marks, emoji, CR LF and tab runs);
- the native merge engine against the plain Python loop, and a failed native
  build raising; the refusals of ``from_file`` / ``load_tokenizer``; HF
  ``tokenizers`` where it is installed;
- the accepted difference: code points assigned after this Python's Unicode
  version are unassigned (Cn) to the port, where the ``regex`` module may
  already class them as letters or numbers.
"""

import json
import os
import sys
import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ssp_x_vit_tpu.llm import tokenizer as jtok
from ssp_x_vit_tpu_torch.llm import tokenizer as ttok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "ckpts", "code_llm_small")
TOKENIZER_JSON = os.path.join(CKPT, "tokenizer.json")
EOT = 8191


@pytest.fixture(scope="module")
def toks():
    """(port native, port python, JAX)."""
    return (ttok.ByteLevelBPETokenizer.from_file(TOKENIZER_JSON),
            ttok.ByteLevelBPETokenizer.from_file(TOKENIZER_JSON, engine="python"),
            jtok.ByteLevelBPETokenizer.from_file(TOKENIZER_JSON))


@pytest.fixture(scope="module")
def val_ids():
    return np.fromfile(os.path.join(CKPT, "corpus_slice", "val.bin"), np.uint16).astype(
        np.int64).tolist()


def test_val_bin_decodes_and_encodes_back_to_the_committed_ids(toks, val_ids):
    port, _, jax_tok = toks
    text = port.decode(val_ids)
    assert text == jax_tok.decode(val_ids)
    got = port.encode(text)
    assert val_ids.count(EOT) == 39 and len(got) == 131_033
    assert got == [i for i in val_ids if i != EOT]
    assert got == jax_tok.encode(text)
    assert port.native_batches > 0


def test_decode_of_every_id_matches_jax(toks):
    port, _, jax_tok = toks
    assert port.vocab_size == jax_tok.vocab_size == 8191
    for i in range(EOT + 2):               # the added token and one past the table decode to ""
        assert port.decode([i]) == jax_tok.decode([i]), i
    ids = list(range(EOT + 1))
    assert port.decode(ids) == jax_tok.decode(ids)
    assert port.decode([EOT]) == ""
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()


# Pieces where the obvious stdlib substitutes for \p{L} / \p{N} / \s go wrong.
NAMED = {
    "file separators": "a\x1cb\x1d c\x1e\x1f d",
    "superscript two": "x² + y²=z²",
    "one half": "½ cup, 3½",
    "cjk": "漢字テスト 한국어",
    "combining marks": "été ño",
    "emoji": "ok 🙂🙂 👍🏽 done",
    "crlf and tabs": "line\r\n\r\n\tindent\t\t x  \n  y",
    "unicode spaces": "a b　c d\u0085e ",
    "contractions": "it's we'll they'd I'm you've 'S",
    "digits": "x1 23 4567 ٣٤ ⅷ",
}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_classes_match_jax(toks, name):
    port, python_loop, jax_tok = toks
    text = NAMED[name]
    assert port.pretokenize(text) == jax_tok._pat.findall(text)
    assert port.encode(text) == jax_tok.encode(text) == python_loop.encode(text)
    assert port.decode(port.encode(text)) == text


ASSIGNED = st.characters(codec="utf-8", exclude_categories=("Cs", "Cn"))


@settings(derandomize=True, deadline=None, max_examples=150)
@given(st.lists(st.one_of(ASSIGNED, st.sampled_from(sorted(NAMED.values()))), max_size=24)
       .map("".join))
def test_hypothesis_text_over_unicode_15_matches_jax(toks, text):
    port, _, jax_tok = toks
    assert port.encode(text) == jax_tok.encode(text)


def test_native_engine_matches_the_python_loop(toks, val_ids):
    port, python_loop, _ = toks
    text = port.decode(val_ids[:20_000]) + "".join(NAMED.values())
    words = list(dict.fromkeys(port.pretokenize(text)))
    syms = [port._initial_syms(w) for w in words]
    assert port._merge_batch_native(syms) == [python_loop._merge_py(s) for s in syms]
    assert python_loop.engine == "python" and python_loop.native_batches == 0
    assert ttok.native_available()


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bpe.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ttok, "_lib", None)
    monkeypatch.setattr(ttok, "BPE_SOURCE", bad)
    monkeypatch.setattr(ttok, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native BPE build failed"):
        ttok.ByteLevelBPETokenizer.from_file(TOKENIZER_JSON)
    with pytest.raises(RuntimeError, match="native BPE build failed"):
        ttok.load_tokenizer(os.path.dirname(TOKENIZER_JSON))
    assert not ttok.native_available()
    plain = ttok.ByteLevelBPETokenizer.from_file(TOKENIZER_JSON, engine="python")
    assert plain.encode("hello world") == jtok.ByteLevelBPETokenizer.from_file(
        TOKENIZER_JSON).encode("hello world")
    with pytest.raises(ValueError, match="engine"):
        ttok.ByteLevelBPETokenizer({}, [], engine="rust")


def _variant(tmp_path, name, edit):
    with open(TOKENIZER_JSON, encoding="utf-8") as f:
        tj = json.load(f)
    edit(tj)
    d = tmp_path / name
    d.mkdir()
    with open(d / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(tj, f)
    return str(d)


def test_refusals_match_jax_and_load_tokenizer_names_the_roadmap_item(tmp_path):
    """The byte-level class refuses what the JAX one refuses; ``load_tokenizer``
    then runs the file's whole pipeline (``llm/hf_tokenizer.py``, the ids of
    the ``tokenizers`` library on the same file), names ROADMAP.md A.10g for a
    WordPiece model, and raises ``OSError`` on a directory with no tokenizer."""
    tokenizers = pytest.importorskip("tokenizers")
    from ssp_x_vit_tpu_torch.llm.hf_tokenizer import HFTokenizer

    metaspace = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first"}
    split = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": "\\d{1,3}"}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": False}]}
    cases = {
        "wordpiece": (lambda tj: tj["model"].update(type="WordPiece"), "unsupported tokenizer"),
        "metaspace": (lambda tj: tj.update(pre_tokenizer=metaspace), "no ByteLevel"),
        "split": (lambda tj: tj.update(pre_tokenizer=split), "Split"),
    }
    for name, (edit, match) in cases.items():
        d = _variant(tmp_path, name, edit)
        path = os.path.join(d, "tokenizer.json")
        with pytest.raises(ValueError, match=match):
            jtok.ByteLevelBPETokenizer.from_file(path)
        with pytest.raises(ValueError, match=match):
            ttok.ByteLevelBPETokenizer.from_file(path)
        if name == "wordpiece":
            with pytest.raises(ValueError, match=r"WordPiece.*ROADMAP\.md A\.10g"):
                ttok.load_tokenizer(d)
            continue
        port, ref = ttok.load_tokenizer(d), tokenizers.Tokenizer.from_file(path)
        assert isinstance(port, HFTokenizer)
        for text in ("hello 12345 world", "  two\nlines ü", *NAMED.values()):
            ids = port.encode(text)
            assert ids == ref.encode(text).ids
            assert port.decode(ids) == ref.decode(ids, skip_special_tokens=False)
    with pytest.raises(OSError, match="neither tokenizer.json nor tokenizer.model"):
        ttok.load_tokenizer(str(tmp_path))
    prefixed = _variant(tmp_path, "prefix", lambda tj: tj["pre_tokenizer"].update(
        add_prefix_space=True))
    port, jax_tok = ttok.load_tokenizer(prefixed), jtok.load_tokenizer(prefixed)
    assert port.encode("hello there") == jax_tok.encode("hello there")
    assert port.encode("hello")[0] != ttok.load_tokenizer(CKPT).encode("hello")[0]


def test_agrees_with_hf_tokenizers(toks, val_ids):
    tokenizers = pytest.importorskip("tokenizers")
    hf = tokenizers.Tokenizer.from_file(TOKENIZER_JSON)
    port = toks[0]
    for text in [port.decode(val_ids[:4000])] + list(NAMED.values()):
        assert port.encode(text) == hf.encode(text, add_special_tokens=False).ids
    assert port.decode(val_ids[:4000]) == hf.decode(
        [i for i in val_ids[:4000] if i != EOT], skip_special_tokens=True)


def test_code_points_after_unicode_15_are_the_accepted_difference(toks):
    """Every code point whose class (letter, number, whitespace) differs
    between the port and the ``regex`` module is unassigned in this Python's
    ``unicodedata``; a letter ``regex`` knows from a later Unicode splits a
    word for the port."""
    regex = pytest.importorskip("regex")
    port, _, jax_tok = toks
    pl, pn, ps = regex.compile(r"\p{L}"), regex.compile(r"\p{N}"), regex.compile(r"\s")
    pat = ttok.gpt2_pattern()
    differ = []
    for c in range(sys.maxunicode + 1):
        ch = chr(c)
        cat = unicodedata.category(ch)
        ours = (cat[0] == "L", cat[0] == "N", ch.isspace() and not 0x1C <= c <= 0x1F)
        theirs = (bool(pl.match(ch)), bool(pn.match(ch)), bool(ps.match(ch)))
        if ours != theirs:
            differ.append(c)
    assert differ and all(unicodedata.category(chr(c)) == "Cn" for c in differ)
    assert pat.findall("a\x1cb") == jax_tok._pat.findall("a\x1cb") == ["a", "\x1c", "b"]
    letter = next(c for c in differ if pl.match(chr(c)))
    word = f"ab{chr(letter)}cd"
    assert jax_tok._pat.findall(word) == [word]
    assert port.pretokenize(word) == ["ab", chr(letter), "cd"]
