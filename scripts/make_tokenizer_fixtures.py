"""Write the committed tokenizer fixtures under ``tests/fixtures/tokenizers/``.

Each fixture is a directory with ``tokenizer.json``, ``tokenizer_config.json``
and ``expected.json``: the ids that the JAX package's ``load_tokenizer``
(``transformers.AutoTokenizer`` over the ``tokenizers`` library) gives for
fixed texts, with and without special tokens, their decoded text, the special
token ids, and the length and sha256 of the ids of the whole decoded
``ckpts/code_llm_small/corpus_slice/val.bin`` text. The port's tests and
``chip_smoke.py`` (on a machine without ``tokenizers``) hold the port to them.

- ``llama2``: Llama-2-style BPE with byte fallback (``Prepend`` + ``Replace``
  normalizer, no pre-tokenizer, ids 0-2 ``<unk>`` / ``<s>`` / ``</s>``, 3-258
  ``<0x00>``-``<0xFF>``), 8192 pieces, ``LlamaTokenizerFast``;
- ``qwen_split``: byte-level BPE with Qwen2's ``Split`` pattern and ``NFC``,
  8003 ids (under ``code_llm_small``'s vocabulary of 8192),
  ``Qwen2TokenizerFast``;
- ``unigram``: a Unigram model behind ``Metaspace`` with byte fallback
  (``ByteFallback`` then ``Metaspace`` to decode) and an EOS template,
  ``PreTrainedTokenizerFast``.

Each is trained with ``tokenizers``' trainers on the decoded
``corpus_slice/train.bin`` text. This script needs ``tokenizers``,
``transformers`` and the JAX package, so it runs where the tests run, not on
the card's machine::

    python scripts/make_tokenizer_fixtures.py            # all three
    python scripts/make_tokenizer_fixtures.py --expected-only   # ids only
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "tokenizers")
CKPT = os.path.join(ROOT, "ckpts", "code_llm_small")

TEXTS = [
    "Who is Albert Einstein?",
    "The theory of relativity",
    "def fibonacci(n):\n    if n < 2:\n        return n\n    return fibonacci(n - 1)\n",
    "  leading and  double  spaces\n\nnew paragraph\t\ttabs \r\n",
    "emoji 😀🎉 and CJK 漢字テスト 한국어",
    "specials mid-text: a<s>b</s> <unk> <|endoftext|><|im_start|>user",
    "Über naïve café — ½ x² ΣΑΣ ſ İ",
    "it's 'LL 'VE contractions 12345 678 3.14159",
    "rare pieces: ꙮ ᚠ 𓀀 ⿰",
    "",
]

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

CONFIGS = {
    "llama2": {"tokenizer_class": "LlamaTokenizerFast", "add_bos_token": True,
               "add_eos_token": False, "bos_token": "<s>", "eos_token": "</s>",
               "unk_token": "<unk>", "pad_token": None, "legacy": True,
               "clean_up_tokenization_spaces": False, "model_max_length": 4096},
    "qwen_split": {"tokenizer_class": "Qwen2TokenizerFast", "bos_token": None,
                   "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
                   "unk_token": None, "clean_up_tokenization_spaces": False,
                   "additional_special_tokens": ["<|im_start|>", "<|im_end|>"],
                   "model_max_length": 32768},
    "unigram": {"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
                "eos_token": "</s>", "unk_token": "<unk>", "clean_up_tokenization_spaces": False},
}


def decoded_text(split: str) -> str:
    """``corpus_slice/<split>.bin`` decoded with ``code_llm_small``'s tokenizer."""
    from ssp_x_vit_tpu.llm.tokenizer import ByteLevelBPETokenizer

    ids = np.fromfile(os.path.join(CKPT, "corpus_slice", f"{split}.bin"), np.uint16)
    tok = ByteLevelBPETokenizer.from_file(os.path.join(CKPT, "tokenizer.json"))
    return tok.decode(ids.tolist())


def _documents(text: str):
    return [d for d in text.split("\n\n") if d.strip()]


def _byte_pieces():
    return [f"<0x{b:02X}>" for b in range(256)]


def train_llama2(text: str) -> dict:
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    specials = ["<unk>", "<s>", "</s>"]
    tok.train_from_iterator(_documents(text), trainers.BpeTrainer(
        vocab_size=8192 - 256, special_tokens=specials, limit_alphabet=160,
        show_progress=False))
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    rest = [t for t in sorted(vocab, key=vocab.get) if t not in specials]
    spec["model"]["vocab"] = {t: i for i, t in enumerate(specials + _byte_pieces() + rest)}
    spec["added_tokens"] = [dict(id=i, content=t, single_word=False, lstrip=False, rstrip=False,
                                 normalized=False, special=True) for i, t in enumerate(specials)]
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"},
        {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
    spec["pre_tokenizer"] = None
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                   {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                 {"Sequence": {"id": "A", "type_id": 0}},
                 {"SpecialToken": {"id": "<s>", "type_id": 1}},
                 {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}}
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
        {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    return spec


def train_qwen_split(text: str) -> dict:
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers,
                            processors, trainers)

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(_documents(text), trainers.BpeTrainer(
        vocab_size=8000, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    tok.add_special_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return json.loads(tok.to_str())


def train_unigram(text: str) -> dict:
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always")
    specials = ["<unk>", "<s>", "</s>"]
    tok.train_from_iterator(_documents(text), trainers.UnigramTrainer(
        vocab_size=3000, special_tokens=specials, unk_token="<unk>", show_progress=False))
    spec = json.loads(tok.to_str())
    pieces = spec["model"]["vocab"]
    spec["model"]["vocab"] = pieces[:3] + [[b, 0.0] for b in _byte_pieces()] + pieces[3:]
    spec["model"]["byte_fallback"] = True
    spec["model"]["unk_id"] = 0
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "ByteFallback"},
        {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}]}
    for t in spec["added_tokens"]:
        t["id"] = specials.index(t["content"])
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"Sequence": {"id": "A", "type_id": 0}},
                   {"SpecialToken": {"id": "</s>", "type_id": 0}}],
        "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                 {"Sequence": {"id": "B", "type_id": 1}},
                 {"SpecialToken": {"id": "</s>", "type_id": 1}}],
        "special_tokens": {"</s>": {"id": "</s>", "ids": [2], "tokens": ["</s>"]}}}
    return spec


TRAIN = {"llama2": train_llama2, "qwen_split": train_qwen_split, "unigram": train_unigram}


def ids_digest(ids) -> str:
    return hashlib.sha256(np.asarray(ids, "<i4").tobytes()).hexdigest()


def expected_for(directory: str, val_text: str) -> dict:
    """What the JAX package's ``load_tokenizer`` gives on ``directory``."""
    from ssp_x_vit_tpu.llm.tokenizer import load_tokenizer

    tok = load_tokenizer(directory)
    ids = [tok(t)["input_ids"] for t in TEXTS]
    val = tok(val_text, add_special_tokens=False)["input_ids"]
    return {
        "texts": TEXTS,
        "ids": ids,
        "ids_plain": [tok(t, add_special_tokens=False)["input_ids"] for t in TEXTS],
        "decoded": [tok.decode(i) for i in ids],
        "decoded_skip": [tok.decode(i, skip_special_tokens=True) for i in ids],
        "bos_token_id": tok.bos_token_id,
        "eos_token_id": tok.eos_token_id,
        "all_special_ids": list(tok.all_special_ids),
        "vocab_size": tok.vocab_size,
        "val": {"chars": len(val_text), "tokens": len(val), "sha256": ids_digest(val)},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--expected-only", action="store_true",
                   help="Keep the tokenizer files; rewrite expected.json only")
    p.add_argument("--names", nargs="*", default=list(TRAIN))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    train_text, val_text = decoded_text("train"), decoded_text("val")
    for name in args.names:
        d = os.path.join(FIXTURES, name)
        os.makedirs(d, exist_ok=True)
        if not args.expected_only:
            with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
                json.dump(TRAIN[name](train_text), f, ensure_ascii=False)
            with open(os.path.join(d, "tokenizer_config.json"), "w", encoding="utf-8") as f:
                json.dump(CONFIGS[name], f, indent=1)
        with open(os.path.join(d, "expected.json"), "w", encoding="utf-8") as f:
            json.dump(expected_for(d, val_text), f, ensure_ascii=False)
        size = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))
        print(f"{name}: {size / 1e6:.3f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
