"""The port's Oniguruma translation (``llm/unicode_re.py``) and its byte-level
BPE tokenizers with their own ``Split`` patterns (``llm/hf_tokenizer.py``)
against the ``regex`` module and the JAX package's ``load_tokenizer`` on the
CPU.

- Every pattern the port must translate exactly: GPT-2's, Llama-3's, Qwen2 /
  Qwen3's and the three of DeepSeek-V3's ``Split`` sequence, transcribed
  from the public ``tokenizer.json`` files: ``re`` on the translation finds
  the spans the ``regex`` module finds on the original, on fixed and on
  generated text (code points assigned in this Python's Unicode 15.0; later
  ones are the accepted difference of ROADMAP.md).
- The constructs it refuses, by name.
- Qwen2-, Llama-3- (``ignore_merges``, a BOS template, cleaned-up decode) and
  DeepSeek-V3-style (the three ``Split`` patterns, ``LlamaTokenizerFast``'s
  BOS) files made from the committed ``qwen_split`` fixture: ids with and
  without special tokens, decoded text with and without
  ``skip_special_tokens`` and the special ids equal to the JAX package's
  ``load_tokenizer`` (``transformers.AutoTokenizer``); the fixture's
  ``expected.json`` regenerated by its script equals the committed one.
"""

import json
import os
import re
import sys
import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import torch_tokenizer_dirs as dirs
from ssp_x_vit_tpu.llm.tokenizer import load_tokenizer as jax_load_tokenizer
from ssp_x_vit_tpu_torch.llm import unicode_re
from ssp_x_vit_tpu_torch.llm.hf_tokenizer import HFTokenizer
from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

regex = pytest.importorskip("regex")

PATTERNS = {"gpt2": dirs.GPT2_PATTERN, "llama3": dirs.LLAMA3_PATTERN,
            "qwen2": dirs.QWEN2_PATTERN, "deepseek_v3_digits": dirs.DEEPSEEK_V3_PATTERNS[0],
            "deepseek_v3_cjk": dirs.DEEPSEEK_V3_PATTERNS[1],
            "deepseek_v3_words": dirs.DEEPSEEK_V3_PATTERNS[2]}
CLASS_TEXT = st.lists(st.one_of(
    st.sampled_from(["'s", "'S", "'ll", "'LL", "'Re", " ", "  ", "\n", "\r\n", "\t", "1234",
                     "漢字", "かな", "カナ", "!?", "#x", "-", "ſ", "\x1c", "\x85", "　"]),
    st.characters(exclude_categories=("Cs", "Cn"))), max_size=30).map("".join)


def _spans(pattern, text):
    return [m.span() for m in pattern.finditer(text)]


@pytest.mark.parametrize("name", list(PATTERNS))
def test_translated_pattern_matches_the_regex_module(name):
    ours = unicode_re.compile_onig(PATTERNS[name])
    theirs = regex.compile(PATTERNS[name])
    for text in dirs.texts("qwen2") + ["x² ½ ¾ ١٢٣ Ⅻ", "Ab'sCD 'd'd", "\r\n\r\n  \n x"]:
        assert _spans(ours, text) == _spans(theirs, text), text

    @settings(max_examples=60, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(CLASS_TEXT)
    def sweep(text):
        assert _spans(ours, text) == _spans(theirs, text)
    sweep()


def test_category_classes_cover_unicode_15_as_the_regex_module_does():
    """Each class the patterns use holds the code points the ``regex`` module
    puts there, but for code points this Python's Unicode (15.0) does not
    assign and U+0295 (Ll in 15.0, Lo since 16.0)."""
    assert unicodedata.unidata_version == "15.0.0"
    every = "".join(chr(c) for c in range(sys.maxunicode + 1) if not 0xD800 <= c <= 0xDFFF)
    for name in (r"\p{L}", r"\p{N}", r"\p{P}", r"\p{S}", r"\p{M}", r"\s", r"\p{Ll}", r"\d"):
        ours = set(re.compile(unicode_re.translate(name)).findall(every))
        differ = ours ^ set(regex.compile(name).findall(every))
        assigned = sorted(ord(c) for c in differ if unicodedata.category(c) != "Cn")
        assert assigned == ([0x295] if name == r"\p{Ll}" else []), (name, assigned[:5])
    assert not re.match(unicode_re.translate(r"\s"), "\x1c")     # re's own \s says yes


def test_translation_of_the_other_constructs():
    t = unicode_re.translate
    assert re.fullmatch(t(r"(?i:ab)\x41\x{1F600}é"), "aBA😀é")
    assert re.findall(t(r"^x|x$"), "x\nx\nyx") == ["x", "x", "x"]     # line anchors, as Ruby
    assert re.fullmatch(t(r"\A[\p{Lu}\P{L}]+\z"), "AB12!")
    assert re.fullmatch(t(r"[^\p{^N}]{2}"), "12") and not re.match(t(r"\p{^N}"), "1")
    assert re.fullmatch(t(r"(?<w>a)(?>b+)c*+d?+"), "abbbccd")
    assert re.fullmatch(t(r"[\-\]a-c]+"), "-]abc")
    assert re.fullmatch(t(r"\p{Lo}\p{Nd}"), "字7")
    assert re.fullmatch(t(r"a{,2}b{2}c{1,}"), "aabbccc")
    for bad, what in ((r"\w+", r"\\w"), (r"a{1,2}+", "repeated interval"),
                      (r"[[:alpha:]]", "POSIX"), (r"\bx", r"\\b"), (r"(?m:x)", "inline flag"),
                      (r"\p{Han}", "Han"), (r"\p{Letter}", "Letter"), (r"(a)\1", r"\\1"), (r"[a-z&&[^aeiou]]", "&&")):
        with pytest.raises(ValueError, match=what):
            t(bad)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """family -> (port tokenizer, JAX tokenizer) on one directory."""
    root = tmp_path_factory.mktemp("split")
    out = {}
    for family in dirs.SPLIT_FAMILIES:
        d = dirs.write_family(root, family)
        out[family] = (load_tokenizer(d), jax_load_tokenizer(d))
    return out


@pytest.mark.parametrize("family", dirs.SPLIT_FAMILIES)
def test_split_family_matches_jax_load_tokenizer(families, family):
    port, ref = families[family]
    assert isinstance(port, HFTokenizer)
    assert type(ref).__name__.endswith("Fast")
    for text in dirs.texts(family):
        for add in (True, False):
            ids = port(text, add_special_tokens=add)["input_ids"]
            assert ids == ref(text, add_special_tokens=add)["input_ids"], (text, add)
        ids = port.encode(text)
        assert ids == ref.encode(text)
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), (text, skip)
    assert (port.bos_token_id, port.eos_token_id) == (ref.bos_token_id, ref.eos_token_id)
    assert port.all_special_ids == ref.all_special_ids
    assert port.vocab_size == ref.vocab_size
    if family != "qwen2":
        assert port.encode("hi")[0] == port.bos_token_id != None


@pytest.mark.parametrize("family", dirs.SPLIT_FAMILIES)
def test_split_family_sweep(families, family):
    port, ref = families[family]

    @settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    @given(dirs.TEXT)
    def sweep(text):
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert port.decode(ids) == ref.decode(ids)
    sweep()


def test_llama3_ignore_merges_takes_a_vocabulary_word_whole(families):
    """``ignore_merges``: a pre-token that is a vocabulary entry is emitted
    whole, where the merges alone would split it."""
    port, ref = families["llama3"]
    model = port.model
    text = " xyzzy plugh quux xyzzyx"
    ids = port.encode(text, False)
    assert ids == ref.encode(text, add_special_tokens=False)
    whole = [model.vocab[w] for w in dirs.IGNORE_MERGES_WORDS]
    assert ids[:3] == whole and whole[0] not in ids[3:]
    for w, i in zip(dirs.IGNORE_MERGES_WORDS, whole):
        assert model.merger.merge_batch([model.initial_symbols(w)])[0] != [i]


def test_committed_expected_ids_are_what_jax_gives_today():
    """``scripts/make_tokenizer_fixtures.py --expected-only`` on the
    ``qwen_split`` fixture gives the committed ``expected.json``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_tokenizer_fixtures", os.path.join(dirs.ROOT, "scripts", "make_tokenizer_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.expected_for(dirs.fixture_dir("qwen_split"), mod.decoded_text("val"))
    assert json.loads(json.dumps(got)) == dirs.read("qwen_split", "expected.json")
