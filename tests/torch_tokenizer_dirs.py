"""Tokenizer directories for the port's tokenizer tests, made from the committed
fixtures under ``tests/fixtures/tokenizers/`` (``scripts/make_tokenizer_fixtures.py``).

Each family is a fixture's ``tokenizer.json`` with the nodes that family's
public file has (its normalizer, pre-tokenizer, post-processor, decoder and
special tokens) and a ``tokenizer_config.json`` naming a fast class, because
the JAX package's ``load_tokenizer`` (``AutoTokenizer(use_fast=False)``)
needs ``sentencepiece`` for the slow ``LlamaTokenizer`` and this host has none.
The ``Split`` patterns are transcribed from the public ``tokenizer.json`` files
of Llama-3, Qwen2 / Qwen3 and DeepSeek-V3.
"""

import copy
import json
import os

from hypothesis import strategies as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "tokenizers")

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                  r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
DEEPSEEK_V3_PATTERNS = [
    "\\p{N}{1,3}",
    "[一-龥぀-ゟ゠-ヿ]+",
    "[!\"#$%&'()*+,\\-./:;<=>?@\\[\\\\\\]^_`{|}~][A-Za-z]+|[^\r\n\\p{L}\\p{P}\\p{S}]?"
    "[\\p{L}\\p{M}]+| ?[\\p{P}\\p{S}]+[\r\n]*|\\s*[\r\n]+|\\s+(?!\\S)|\\s+",
]
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"
                r"|\s+")

# vocabulary entries of the Llama-3-style file that its merges never build
# (byte-level forms of " xyzzy", " plugh", " quux")
IGNORE_MERGES_WORDS = ("Ġxyzzy", "Ġplugh", "Ġquux")

SPM_FAMILIES = ("llama2", "llama2_metaspace", "mistral", "gemma", "unigram")
SPLIT_FAMILIES = ("qwen2", "llama3", "deepseek_v3")

# Text the fixed texts do not cover: added tokens mid-word, space runs,
# characters missing from the vocabularies (byte fallback), a literal byte
# piece and unk, CR LF, combining marks, the file separators.
EXTRA_TEXTS = [
    "x<s>y</s>z [INST] hi [/INST]<bos><eos><pad><|begin_of_text|>",
    "<｜begin▁of▁sentence｜>DeepSeek<｜end▁of▁sentence｜>",
    " one leading space",
    "   three leading, trailing   ",
    "tab\tand\r\nCRLF\n\n\n",
    "a\x1cb\x1d c\x1e\x1f d",
    "é ño NFC: é ñ Å Å",
    "literal <0x41> and <unk> <0xZZ>",
    "▁ already escaped ▁▁x",
    "数字12345６７８ and 漢字かなカナ",
    "🧑‍💻 👩🏽‍🚀 ⿰⿱ 𝔘𝔫𝔦𝔠𝔬𝔡𝔢",
    "'S 'T 'Re 'vE 'M 'Ll 'D ſ",
]

# a few dozen hypothesis cases per family: ASCII, the pieces above and any
# code point assigned in this Python's Unicode (15.0)
_PIECES = ["<s>", "</s>", "<unk>", "[INST]", "<|endoftext|>", "<|im_start|>", "<bos>",
           "<｜begin▁of▁sentence｜>", "  ", "\n\n", "▁", "'s", "'LL", "12345", "<0x0A>"]
TEXT = st.lists(st.one_of(st.sampled_from(_PIECES),
                          st.characters(min_codepoint=0x20, max_codepoint=0x7E),
                          st.characters(exclude_categories=("Cs", "Cn"))),
                max_size=24).map("".join)


def fixture_dir(name: str) -> str:
    return os.path.join(FIXTURES, name)


def read(name: str, file: str) -> dict:
    with open(os.path.join(FIXTURES, name, file), encoding="utf-8") as f:
        return json.load(f)


def _special(content: str, i: int) -> dict:
    return dict(id=i, content=content, single_word=False, lstrip=False, rstrip=False,
                normalized=False, special=True)


def _template(bos: str, bos_id: int) -> dict:
    return {"type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": bos, "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {bos: {"id": bos, "ids": [bos_id], "tokens": [bos]}}}


def _split_sequence(patterns) -> dict:
    return {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": p}, "behavior": "Isolated", "invert": False}
        for p in patterns] + [{"type": "ByteLevel", "add_prefix_space": False,
                               "trim_offsets": True, "use_regex": False}]}


def family_files(family: str):
    """(tokenizer.json dict, tokenizer_config.json dict) of ``family``."""
    if family in ("llama2", "unigram", "qwen2"):
        name = "qwen_split" if family == "qwen2" else family
        return read(name, "tokenizer.json"), read(name, "tokenizer_config.json")
    if family in ("llama2_metaspace", "mistral", "gemma"):
        spec, config = read("llama2", "tokenizer.json"), read("llama2", "tokenizer_config.json")
        spec = copy.deepcopy(spec)
        if family == "llama2_metaspace":     # the newer conversion: no normalizer
            spec["normalizer"] = None
            spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                                     "prepend_scheme": "first", "split": False}
        elif family == "mistral":            # control tokens after the vocabulary
            spec["added_tokens"] += [_special("[INST]", 8192), _special("[/INST]", 8193)]
        else:                                # Gemma: no dummy prefix, <bos> / <eos> / <pad>
            vocab = spec["model"]["vocab"]
            for old, new in (("<s>", "<bos>"), ("</s>", "<eos>")):
                vocab[new] = vocab.pop(old)
            spec["added_tokens"] = [_special(c, i) for i, c in
                                    enumerate(["<unk>", "<bos>", "<eos>"])] + [
                _special("<pad>", 8192)]
            spec["normalizer"] = {"type": "Replace", "pattern": {"String": " "},
                                  "content": "▁"}
            spec["decoder"]["decoders"] = spec["decoder"]["decoders"][:3]
            spec["post_processor"] = _template("<bos>", 1)
            config = {"tokenizer_class": "GemmaTokenizerFast", "add_bos_token": True,
                      "add_eos_token": False}
        return spec, config
    spec = copy.deepcopy(read("qwen_split", "tokenizer.json"))
    if family == "llama3":
        spec["normalizer"] = None
        spec["model"]["ignore_merges"] = True
        vocab = spec["model"]["vocab"]       # words no merge makes: ignore_merges takes them
        for word in IGNORE_MERGES_WORDS:
            vocab[word] = len(vocab)
        spec["pre_tokenizer"] = _split_sequence([LLAMA3_PATTERN])
        bos_id = len(vocab) + len(spec["added_tokens"])
        spec["added_tokens"] += [_special("<|begin_of_text|>", bos_id),
                                 _special("<|end_of_text|>", bos_id + 1)]
        spec["post_processor"] = {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True}, _template("<|begin_of_text|>", bos_id)]}
        config = {"tokenizer_class": "PreTrainedTokenizerFast",
                  "bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
                  "clean_up_tokenization_spaces": True}
    elif family == "deepseek_v3":
        bos, eos = "<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"
        spec["normalizer"] = None
        spec["pre_tokenizer"] = _split_sequence(DEEPSEEK_V3_PATTERNS)
        spec["added_tokens"] += [_special(bos, 8003), _special(eos, 8004)]
        spec["post_processor"] = _template(bos, 8003)
        config = {"tokenizer_class": "LlamaTokenizerFast", "add_bos_token": True,
                  "add_eos_token": False, "bos_token": {"__type": "AddedToken", "content": bos,
                                                        "lstrip": False, "normalized": True,
                                                        "rstrip": False, "single_word": False},
                  "eos_token": eos, "pad_token": eos, "unk_token": None, "legacy": True,
                  "clean_up_tokenization_spaces": False}
    else:
        raise ValueError(family)
    return spec, config


def write_family(root, family: str) -> str:
    """``root/family`` holding the family's two files; returns its path."""
    spec, config = family_files(family)
    d = os.path.join(str(root), family)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(d, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f)
    return d


def texts(family: str):
    """The fixture's fixed texts and ``EXTRA_TEXTS``."""
    name = {"unigram": "unigram", "qwen2": "qwen_split", "llama3": "qwen_split",
            "deepseek_v3": "qwen_split"}.get(family, "llama2")
    return read(name, "expected.json")["texts"] + EXTRA_TEXTS
