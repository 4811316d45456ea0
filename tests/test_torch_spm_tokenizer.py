"""The port's SentencePiece-style and Unigram ``tokenizer.json`` pipelines
(``llm/hf_tokenizer.py`` through ``llm/tokenizer.py`` ``load_tokenizer``)
against the JAX package's ``load_tokenizer`` on the same directory, on the CPU.

The families, made from the committed ``llama2`` and ``unigram`` fixtures
(``tests/torch_tokenizer_dirs.py``): Llama-2 in its older form (``Prepend`` +
``Replace`` normalizer, no pre-tokenizer) and its newer one (``Metaspace``
with ``prepend_scheme: first`` and ``split: false``), Mistral-style (control
tokens after the vocabulary), Gemma-style (``Replace`` only, no dummy prefix,
``GemmaTokenizerFast``'s default special tokens), a Unigram file (``Metaspace``,
byte fallback, an EOS template), and Llama-2 without a ``<0xF0>`` piece (the
characters that need it become one fused ``<unk>``). Each
``tokenizer_config.json`` names a fast class: ``LlamaTokenizer`` needs
``sentencepiece``, which this host lacks, so the contract is the ``tokenizers``
pipeline that ``AutoTokenizer`` runs here.

Held equal: ``__call__`` / ``encode`` with and without special tokens,
``decode`` with and without ``skip_special_tokens``, the BOS / EOS ids,
``all_special_ids`` and ``vocab_size``, on the fixtures' fixed texts, on text
with added tokens mid-word, space runs, newlines, emoji, CJK and characters
missing from the vocabulary, on truncated and invalid UTF-8 in ``decode``, and
on a hypothesis sweep over Unicode text (code points assigned in Unicode 15.0).
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings

import torch_tokenizer_dirs as dirs
from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm.tokenizer import load_tokenizer as jax_load_tokenizer
from ssp_x_vit_tpu_torch.llm import datasets as tdata
from ssp_x_vit_tpu_torch.llm.hf_tokenizer import HFTokenizer
from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

FAMILIES = dirs.SPM_FAMILIES + ("llama2_no_f0",)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(root, family):
    if family != "llama2_no_f0":
        return dirs.write_family(root, family)
    import json

    d = dirs.write_family(root, "llama2")
    target = os.path.join(str(root), family)
    os.rename(d, target)
    path = os.path.join(target, "tokenizer.json")
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    del spec["model"]["vocab"]["<0xF0>"]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return target


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """family -> (port tokenizer, JAX tokenizer) on one directory."""
    root = tmp_path_factory.mktemp("spm")
    return {family: (load_tokenizer(d), jax_load_tokenizer(d))
            for family, d in ((f, _write(root, f)) for f in FAMILIES)}


def _check(port, ref, text):
    for add in (True, False):
        assert port(text, add_special_tokens=add)["input_ids"] == ref(
            text, add_special_tokens=add)["input_ids"], (text, add)
    ids = port.encode(text)
    assert ids == ref.encode(text), text
    for skip in (False, True):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
            ids, skip_special_tokens=skip), (text, skip)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_matches_jax_load_tokenizer(families, family):
    port, ref = families[family]
    assert isinstance(port, HFTokenizer) and type(ref).__name__.endswith("Fast")
    for text in dirs.texts(family) + ["😀😀 two emoji", "ꙮꙮ x ꙮ"]:
        _check(port, ref, text)
    assert (port.bos_token_id, port.eos_token_id) == (ref.bos_token_id, ref.eos_token_id)
    assert port.all_special_ids == ref.all_special_ids
    assert port.vocab_size == ref.vocab_size
    if family != "unigram":        # the Llama / Gemma classes add BOS, the Unigram file EOS
        assert port.encode("x")[0] == port.bos_token_id
    else:
        assert port.encode("x")[-1] == port.eos_token_id


@pytest.mark.parametrize("family", FAMILIES)
def test_family_sweep(families, family):
    port, ref = families[family]

    @settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    @given(dirs.TEXT)
    def sweep(text):
        _check(port, ref, text)
    sweep()


def test_byte_pieces_are_vocabulary_and_missing_ones_fuse_to_unk(families):
    """``<0xXX>`` pieces are ordinary vocabulary (``skip_special_tokens``
    keeps them); a character whose bytes lack a piece becomes ``<unk>``, and
    a run of them one ``<unk>`` (``fuse_unk``)."""
    port, ref = families["llama2"]
    ids = port.encode("ꙮ", add_special_tokens=False)
    assert ids == [port.token_to_id("▁")] + [port.token_to_id(f"<0x{b:02X}>")
                                            for b in "ꙮ".encode()]
    assert not set(ids[1:]) & set(port.all_special_ids)
    assert port.decode(ids, skip_special_tokens=True) == ref.decode(
        ids, skip_special_tokens=True) == "ꙮ"
    port, ref = families["llama2_no_f0"]
    unk = port.unk_token_id
    ids = port.encode("😀😀🎉 x 😀", add_special_tokens=False)
    assert ids == ref.encode("😀😀🎉 x 😀", add_special_tokens=False)
    assert ids.count(unk) == 2 and port.decode(ids) == ref.decode(ids)


TRUNCATED = [
    [0xE6, 0x97],                 # 2 of a 3-byte character
    [0xF0, 0x9F, 0x98],           # 3 of 4
    [0x80],                       # a lone continuation byte
    [0xC0, 0xAF],                 # an overlong form
    [0xE6, 0x97, 0xA5, 0xF0],     # a whole character, then a lead byte alone
    [0xED, 0xA0, 0x80],           # a surrogate
    [0xFF, 0x41],
]


@pytest.mark.parametrize("family", ("llama2", "gemma", "unigram"))
def test_decode_of_truncated_utf8_matches(families, family):
    port, ref = families[family]
    word = port.token_to_id("▁the") or port.token_to_id("the")
    for seq in TRUNCATED:
        pieces = [port.token_to_id(f"<0x{b:02X}>") for b in seq]
        for ids in (pieces, [word] + pieces, pieces + [word], pieces + [word] + pieces[:1]):
            for skip in (False, True):
                assert port.decode(ids, skip) == ref.decode(ids, skip_special_tokens=skip), ids
    # ids outside both vocabularies are dropped, as the tokenizers library does
    assert port.decode([10 ** 6, word]) == ref.decode([10 ** 6, word])


def test_tokenize_corpus_matches(families):
    port, ref = families["llama2"]
    texts = ["first document", " second  one\n", "ü 漢字"]
    np.testing.assert_array_equal(tdata.tokenize_corpus(texts, port),
                                  jdata.tokenize_corpus(texts, ref))


def test_committed_expected_ids_are_what_jax_gives_today():
    """``scripts/make_tokenizer_fixtures.py --expected-only`` on the ``llama2``
    fixture gives the committed ``expected.json`` (the ids of all of the val
    text included)."""
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location(
        "make_tokenizer_fixtures", os.path.join(dirs.ROOT, "scripts",
                                                "make_tokenizer_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.expected_for(dirs.fixture_dir("llama2"), mod.decoded_text("val"))
    assert json.loads(json.dumps(got)) == dirs.read("llama2", "expected.json")
