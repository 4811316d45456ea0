"""``tokenizer.model`` (``llm/spm_model.py``) and the heap merge
(``native/bpe_heap.cc``, ``llm/hf_tokenizer.py`` ``HeapMerger``) on the CPU.

- ``parse_model_proto`` reads what ``sentencepiece_model_pb2_new`` (the
  protobuf module ``transformers`` ships) writes: pieces, scores, types, the
  trainer and normalizer fields, defaults where a field is absent.
- Twins: a ``tokenizer.model`` written from the pieces of a ``tokenizer.json``
  (the committed ``llama2`` BPE and ``unigram`` fixtures) in a directory of its
  own, against the JAX package's ``load_tokenizer`` on the ``tokenizer.json``
  twin. The BPE pieces score ``-id``: the trainer numbers a merged piece by
  its merge's rank, so SentencePiece's highest-score merge is the
  ``tokenizer.json``'s lowest-rank merge. (SentencePiece may also join a piece
  from another split of it than the recorded merge; the trained files here
  give the same ids.) The Unigram twin avoids texts that spell a byte piece
  (``<0x41>``): HF's lattice holds those pieces, SentencePiece's does not.
  ``remove_extra_whitespaces`` is held against a twin that trims and collapses
  spaces with ``Replace`` normalizers.
- Refusals: a precompiled charsmap, WORD models, whitespace as a suffix, and
  ``tokenizer.json`` WordPiece / WordLevel models and ``Precompiled``
  normalizers name ROADMAP.md A.10g; a directory with neither file raises
  ``OSError``.
- The heap merge against the plain Python heap and the rescanning loop of
  ``native/bpe.cc`` on every pre-token of ``code_llm_small``'s val text; a
  1,000,000-character string (no pre-tokenizer: one word) through the
  ``llama2`` fixture in seconds, equal to the ``tokenizers`` library's ids;
  a failed build of the heap engine raises.
"""

import copy
import json
import os
import time

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings

import torch_tokenizer_dirs as dirs
from ssp_x_vit_tpu.llm.tokenizer import load_tokenizer as jax_load_tokenizer
from ssp_x_vit_tpu_torch.llm import hf_tokenizer as hft
from ssp_x_vit_tpu_torch.llm import spm_model
from ssp_x_vit_tpu_torch.llm import tokenizer as ttok

pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
CKPT = os.path.join(dirs.ROOT, "ckpts", "code_llm_small")


def write_model(spec: dict, *, model_type: int, add_dummy_prefix=True, remove_extra=False,
                charsmap=b"", suffix=False) -> bytes:
    """A ``ModelProto`` with the pieces of ``spec``'s model, in id order."""
    m = pb.ModelProto()
    vocab = spec["model"]["vocab"]
    scored = ([(t, -float(i)) for t, i in sorted(vocab.items(), key=lambda kv: kv[1])]
              if isinstance(vocab, dict) else [(t, s) for t, s in vocab])
    specials = {t["content"] for t in spec["added_tokens"]}
    for piece, score in scored:
        p = m.pieces.add()
        p.piece, p.score = piece, score
        p.type = (2 if piece == "<unk>" else 3 if piece in specials
                  else 6 if len(piece) == 6 and piece.startswith("<0x") else 1)
    m.trainer_spec.model_type = model_type
    m.trainer_spec.byte_fallback = True
    m.trainer_spec.pad_id = -1
    m.trainer_spec.treat_whitespace_as_suffix = suffix
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = add_dummy_prefix
    m.normalizer_spec.remove_extra_whitespaces = remove_extra
    if charsmap:
        m.normalizer_spec.precompiled_charsmap = charsmap
    return m.SerializeToString()


def _spm_decoder(strip=True):
    decs = [{"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]
    return {"type": "Sequence", "decoders": decs + (
        [{"type": "Strip", "content": " ", "start": 1, "stop": 0}] if strip else [])}


def _twin_dirs(root, name, spec, config, data):
    """(directory with only tokenizer.model, directory with only tokenizer.json)."""
    out = []
    for kind in ("model", "json"):
        d = os.path.join(str(root), f"{name}_{kind}")
        os.makedirs(d)
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump(config, f)
        if kind == "model":
            with open(os.path.join(d, "tokenizer.model"), "wb") as f:
                f.write(data)
        else:
            with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
                json.dump(spec, f, ensure_ascii=False)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """name -> (port's tokenizer.model reader, JAX tokenizer on the twin)."""
    root = tmp_path_factory.mktemp("twins")
    config = dirs.read("llama2", "tokenizer_config.json")
    bpe = dirs.read("llama2", "tokenizer.json")
    trimmed = copy.deepcopy(bpe)
    trimmed["normalizer"]["normalizers"][:0] = [
        {"type": "Replace", "pattern": {"Regex": "\\A +| +\\z"}, "content": ""},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]
    uni = copy.deepcopy(dirs.read("unigram", "tokenizer.json"))
    uni.update(normalizer=copy.deepcopy(bpe["normalizer"]), pre_tokenizer=None,
               decoder=_spm_decoder(), post_processor=None)
    cases = {"bpe": (bpe, write_model(bpe, model_type=2)),
             "bpe_remove_extra": (trimmed, write_model(bpe, model_type=2, remove_extra=True)),
             "unigram": (uni, write_model(uni, model_type=1))}
    out = {}
    for name, (spec, data) in cases.items():
        model_dir, json_dir = _twin_dirs(root, name, spec, config, data)
        out[name] = (ttok.load_tokenizer(model_dir), jax_load_tokenizer(json_dir))
    return out


def test_parse_model_proto_reads_the_protobuf_fields():
    spec = dirs.read("llama2", "tokenizer.json")
    data = write_model(spec, model_type=2, add_dummy_prefix=False, remove_extra=True)
    ref = pb.ModelProto.FromString(data)
    got = spm_model.parse_model_proto(data)
    assert got["pieces"] == [(p.piece, p.score, p.type) for p in ref.pieces]
    assert [t for _, _, t in got["pieces"][:4]] == [2, 3, 3, 6]
    assert got["trainer_spec"] == dict(model_type=2, byte_fallback=True, unk_id=0, bos_id=1,
                                       eos_id=2, pad_id=-1, treat_whitespace_as_suffix=False)
    assert got["normalizer_spec"] == dict(name="identity", precompiled_charsmap=b"",
                                          add_dummy_prefix=False, remove_extra_whitespaces=True,
                                          escape_whitespaces=True)
    m = pb.ModelProto()                      # nothing set: protobuf's defaults
    m.pieces.add().piece = "a"
    empty = spm_model.parse_model_proto(m.SerializeToString())
    assert empty["pieces"] == [("a", 0.0, 1)]
    assert empty["trainer_spec"]["model_type"] == 1 and empty["trainer_spec"]["unk_id"] == 0
    assert empty["normalizer_spec"]["add_dummy_prefix"] is True
    with pytest.raises(ValueError, match="truncated"):
        spm_model.parse_model_proto(data[:-3])


@pytest.mark.parametrize("name", ("bpe", "bpe_remove_extra", "unigram"))
def test_tokenizer_model_matches_its_tokenizer_json_twin(twins, name):
    port, ref = twins[name]
    assert isinstance(port, hft.HFTokenizer)
    texts = [t for t in dirs.texts("llama2") + [" a  b   c ", "   ", "x "] if "<0x" not in t]
    for text in texts:
        for add in (True, False):
            assert port(text, add_special_tokens=add)["input_ids"] == ref(
                text, add_special_tokens=add)["input_ids"], (text, add)
        ids = port.encode(text)
        for skip in (False, True):
            assert port.decode(ids, skip) == ref.decode(ids, skip_special_tokens=skip)
    assert (port.bos_token_id, port.eos_token_id, port.vocab_size) == (
        ref.bos_token_id, ref.eos_token_id, ref.vocab_size)

    @settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    @given(dirs.TEXT.filter(lambda t: "<0x" not in t))
    def sweep(text):
        assert port.encode(text) == ref.encode(text)
    sweep()


def test_refusals_name_the_roadmap_item(tmp_path):
    spec = dirs.read("llama2", "tokenizer.json")
    cases = {"charsmap": dict(model_type=2, charsmap=b"\x01\x02\x03"),
             "word": dict(model_type=3), "suffix": dict(model_type=2, suffix=True)}
    for name, kw in cases.items():
        d = tmp_path / name
        d.mkdir()
        (d / "tokenizer.model").write_bytes(write_model(spec, **kw))
        with pytest.raises(ValueError, match=r"ROADMAP\.md A\.10g"):
            ttok.load_tokenizer(str(d))
    for name, edit in {
            "wordpiece": lambda s: s["model"].update(type="WordPiece"),
            "wordlevel": lambda s: s["model"].update(type="WordLevel"),
            "precompiled": lambda s: s.update(normalizer={"type": "Precompiled",
                                                          "precompiled_charsmap": "AAAA"})}.items():
        d = tmp_path / name
        d.mkdir()
        variant = copy.deepcopy(spec)
        edit(variant)
        (d / "tokenizer.json").write_text(json.dumps(variant))
        with pytest.raises(ValueError, match=r"ROADMAP\.md A\.10g"):
            ttok.load_tokenizer(str(d))
    with pytest.raises(OSError, match="neither tokenizer.json nor tokenizer.model"):
        ttok.load_tokenizer(str(tmp_path))


def _code_llm_merges():
    tok = ttok.ByteLevelBPETokenizer.from_file(os.path.join(CKPT, "tokenizer.json"))
    n = len(tok._left)
    return tok, (tok._left, tok._right, np.arange(n), tok._merged)


def test_heap_merge_matches_the_python_heap_and_native_bpe_cc():
    tok, table = _code_llm_merges()
    native = hft.HeapMerger(*table)
    plain = hft.HeapMerger(*table, engine="python")
    ids = np.fromfile(os.path.join(CKPT, "corpus_slice", "val.bin"), np.uint16)[:30000]
    words = list(dict.fromkeys(tok.pretokenize(tok.decode(ids.tolist()))))
    syms = [tok._initial_syms(w) for w in words]
    got = native.merge_batch(syms)
    assert got == plain.merge_batch(syms)
    assert got == tok._merge_batch_native(syms)          # native/bpe.cc
    assert native.native_batches == 1 and plain.native_batches == 0
    # ties: equal ranks go leftmost first, both engines
    tied = hft.HeapMerger([1, 2], [1, 2], [0, 0], [3, 4])
    for word in ([1, 1, 1], [2, 2, 1, 1, 2, 2, 2], []):
        assert tied.merge_batch([word]) == [tied.merge_py(word)]
    assert tied.merge_py([1, 1, 1]) == [3, 1]
    with pytest.raises(ValueError, match="engine"):
        hft.HeapMerger([], [], [], [], engine="rust")


def test_a_million_character_word_encodes_in_seconds():
    """No pre-tokenizer: a whole corpus reaches BPE as one word. The heap merge
    takes it in seconds (the rescanning loop is quadratic in the word)."""
    tokenizers = pytest.importorskip("tokenizers")
    tok = ttok.load_tokenizer(dirs.fixture_dir("llama2"))
    ids = np.fromfile(os.path.join(CKPT, "corpus_slice", "val.bin"), np.uint16).tolist()
    text = (ttok.load_tokenizer(CKPT).decode(ids) * 3)[:1_000_000]
    t0 = time.perf_counter()
    got = tok.encode(text, add_special_tokens=False)
    seconds = time.perf_counter() - t0
    assert seconds < 20, seconds
    ref = tokenizers.Tokenizer.from_file(os.path.join(dirs.fixture_dir("llama2"),
                                                      "tokenizer.json"))
    assert got == ref.encode(text, add_special_tokens=False).ids
    assert len(got) > 250_000 and tok.model.merger.native_batches >= 1
    head = text[:20_000]
    plain = ttok.load_tokenizer(dirs.fixture_dir("llama2"), engine="python")
    assert plain.encode(head) == tok.encode(head)


def test_a_failed_heap_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bpe_heap.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(hft, "_heap_lib", None)
    monkeypatch.setattr(hft, "HEAP_SOURCE", bad)
    monkeypatch.setattr(ttok, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native BPE build failed"):
        ttok.load_tokenizer(dirs.fixture_dir("llama2"))
    plain = ttok.load_tokenizer(dirs.fixture_dir("llama2"), engine="python")
    assert plain.encode("hello") == jax_load_tokenizer(dirs.fixture_dir("llama2")).encode("hello")
