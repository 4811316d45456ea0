"""The port's reader of ``datasets.save_to_disk`` directories
(``ssp_x_vit_tpu_torch/llm/arrow_ipc.py``) and its corpus loaders
(``llm/datasets.py``) against the JAX package's loaders, which read the same
directories with ``datasets.load_from_disk(dir)["text"]``.

The directories are written here by ``datasets`` (and, for the planted
features the reader refuses, by ``pyarrow`` directly). Every case compares the
lists: the port's ``list[str]`` against ``list(...)`` of JAX's ``Column``,
``None`` where JAX gives ``None``. JAX's loaders reach for the hub when the
directory is missing; ``datasets.load_dataset`` is replaced by a function that
raises ``ConnectionError`` for those calls, so nothing goes to the network.
``scripts/arrow_corpus.py`` (the plain-Python writer the card's machine uses)
is held against ``datasets.load_from_disk``.
"""

import importlib.util
import itertools
import json
import os

import pytest

datasets = pytest.importorskip("datasets")
pa = pytest.importorskip("pyarrow")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from ssp_x_vit_tpu.llm import datasets as jdata  # noqa: E402
from ssp_x_vit_tpu_torch.llm import arrow_ipc  # noqa: E402
from ssp_x_vit_tpu_torch.llm import datasets as tdata  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADERS = [(tdata.load_wikitext2, jdata.load_wikitext2), (tdata.load_c4, jdata.load_c4),
           (tdata.load_fineweb_edu, jdata.load_fineweb_edu)]
TEXTS = ["", "plain ascii", "héllo wörld", "日本語のテキスト", "emoji 🎉 and \t tabs",
         "line one\n\nline two", "  leading spaces", "x" * 5000]


def _arrow_corpus():
    spec = importlib.util.spec_from_file_location(
        "arrow_corpus", os.path.join(ROOT, "scripts", "arrow_corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """The JAX loaders call ``datasets.load_dataset`` (the hub) for a missing
    directory: make that fail as it does offline."""
    def no_hub(*args, **kwargs):
        raise ConnectionError("no network in tests")

    monkeypatch.setattr(datasets, "load_dataset", no_hub)


def both(directory):
    """(port, JAX) results of each loader on ``directory``."""
    out = []
    for tload, jload in LOADERS:
        t, j = tload(directory), jload(directory)
        out.append((t, None if j is None else list(j)))
    return out


def assert_same(directory, expect=None):
    for t, j in both(str(directory)):
        assert t == j
        if expect is not None:
            assert t == expect
    return t


def save(tmp_path, name, data, features=None, **kw):
    path = str(tmp_path / name)
    ds = datasets.Dataset.from_dict(data, features=features)
    ds.save_to_disk(path, **kw)
    return path


def test_strings_empty_and_non_ascii(tmp_path):
    got = assert_same(save(tmp_path, "d", {"text": TEXTS}), TEXTS)
    assert isinstance(got, list) and all(isinstance(t, str) for t in got)


def test_nulls_read_as_none_and_both_fall_back(tmp_path):
    texts = ["a", None, "", None, "ü"]
    path = save(tmp_path, "d", {"text": texts})
    assert_same(path, texts)
    for mod in (tdata, jdata):       # "\n\n".join fails on a None in both packages
        with pytest.raises(TypeError):
            mod.tokenize_corpus(mod.load_wikitext2(path), lambda s, **_: {"input_ids": []})


def test_large_string(tmp_path):
    features = datasets.Features({"text": datasets.Value("large_string")})
    path = save(tmp_path, "d", {"text": TEXTS + [None]}, features=features)
    assert arrow_ipc.read_column(path)._batches[0].large
    assert_same(path, TEXTS + [None])


def test_other_columns_are_skipped(tmp_path):
    """Columns of other types before and after ``text`` (integers, floats,
    lists of strings, a struct, booleans with nulls) are skipped."""
    n = len(TEXTS)
    data = {"id": list(range(n)), "score": [0.5 * i for i in range(n)],
            "tags": [["a", "b"][: i % 3] for i in range(n)],
            "meta": [{"url": f"u{i}", "len": i} for i in range(n)],
            "text": TEXTS, "flag": [None if i % 2 else True for i in range(n)]}
    assert_same(save(tmp_path, "d", data), TEXTS)


def test_shards_and_record_batches(tmp_path, monkeypatch):
    """Three shards, and a shard of three record batches (save_to_disk writes
    batches of 1000 rows), read in order; a batch is decoded when asked for."""
    rows = [f"document {i} {'ß' * (i % 5)}" for i in range(2500)]
    path = save(tmp_path, "d", {"text": rows}, num_shards=3)
    with open(os.path.join(path, "state.json")) as f:
        assert len(json.load(f)["_data_files"]) == 3
    assert_same(path, rows)
    one = save(tmp_path, "one", {"text": rows})
    col = arrow_ipc.read_column(one)
    assert len(col._batches) == 3 and len(col) == 2500
    decoded, decode = [], arrow_ipc._Batch.decode
    monkeypatch.setattr(arrow_ipc._Batch, "decode",
                        lambda self: decoded.append(self.length) or decode(self))
    assert list(itertools.islice(col, 1001)) == rows[:1001]
    assert decoded == [1000, 1000]     # the third batch is not decoded before it is reached
    assert list(col) == rows and decoded[2:] == [1000, 1000, 500]


def test_selected_and_filtered_datasets(tmp_path):
    """``select`` / ``filter`` keep an indices mapping that save_to_disk flattens."""
    ds = datasets.Dataset.from_dict({"text": TEXTS, "n": list(range(len(TEXTS)))})
    ds.select([5, 1, 3]).save_to_disk(str(tmp_path / "sel"))
    assert_same(tmp_path / "sel", [TEXTS[5], TEXTS[1], TEXTS[3]])
    ds.filter(lambda r: r["n"] % 2 == 0).save_to_disk(str(tmp_path / "filt"))
    assert_same(tmp_path / "filt", TEXTS[::2])


def test_dataset_dict_and_missing_directory_give_none(tmp_path, capsys):
    ds = datasets.Dataset.from_dict({"text": TEXTS})
    datasets.DatasetDict({"test": ds, "train": ds}).save_to_disk(str(tmp_path / "dd"))
    assert_same(tmp_path / "dd", None)
    with pytest.raises(KeyError):
        arrow_ipc.read_column(str(tmp_path / "dd"))
    capsys.readouterr()
    assert_same(tmp_path / "missing", None)
    assert tdata.load_wikitext2(None) is None
    out = capsys.readouterr().out
    assert "[INFO] wikitext2 unavailable" in out and "[INFO] fineweb-edu unavailable" in out
    with pytest.raises(FileNotFoundError):
        arrow_ipc.read_column(str(tmp_path))


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(texts=st.lists(st.text(st.characters(blacklist_categories=("Cs",)), max_size=40),
                      min_size=1, max_size=30))
def test_random_unicode_lists(tmp_path_factory, texts):
    path = save(tmp_path_factory.mktemp("h"), "d", {"text": texts})
    assert_same(path, texts)


def test_plain_python_writer_against_datasets(tmp_path):
    """``scripts/arrow_corpus.py``: what it writes ``datasets.load_from_disk``
    reads back equal (shards, batches, non-ASCII, empty strings), and so do
    the port's loaders; it imports neither pyarrow nor datasets."""
    ac = _arrow_corpus()
    rows = TEXTS * 40
    ac.write_dataset(str(tmp_path / "w"), rows, num_shards=3, batch_rows=64)
    assert list(datasets.load_from_disk(str(tmp_path / "w"))["text"]) == rows
    assert_same(tmp_path / "w", rows)
    assert len(arrow_ipc.read_column(str(tmp_path / "w"))._batches) == 3 * 2
    assert ac.documents("a\n\n\n\nb\n\n  \n\nc d") == ["a", "b", "c d"]
    with pytest.raises(TypeError):
        ac.write_dataset(str(tmp_path / "x"), ["a", None])
    with open(os.path.join(ROOT, "scripts", "arrow_corpus.py")) as f:
        source = f.read()
    assert "import pyarrow" not in source and "import datasets" not in source


def _write_stream(path, table, **options):
    os.makedirs(path, exist_ok=True)
    with pa.OSFile(os.path.join(path, "data-00000-of-00001.arrow"), "wb") as sink:
        with pa.ipc.new_stream(sink, table.schema,
                               options=pa.ipc.IpcWriteOptions(**options)) as writer:
            writer.write_table(table)
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump({"_data_files": [{"filename": "data-00000-of-00001.arrow"}]}, f)
    return str(path)


def test_planted_features_are_refused_by_name(tmp_path, capsys):
    """Body compression, a dictionary-encoded column and another type of the
    column raise ValueError naming the feature (the loaders then print the
    JAX notice and give None); the legacy stream form without the
    continuation marker reads."""
    text = pa.array(["a", "bb", None, "ccc"])
    cases = {
        "zstd": (pa.table({"text": text}), dict(compression="zstd"), "compression"),
        "dict": (pa.table({"text": text.dictionary_encode()}), {}, "dictionary"),
        "int": (pa.table({"text": pa.array([1, 2])}), {}, "Int"),
        "bin": (pa.table({"text": pa.array([b"x"], pa.binary())}), {}, "Binary"),
    }
    for name, (table, options, feature) in cases.items():
        path = _write_stream(tmp_path / name, table, **options)
        with pytest.raises(ValueError, match=feature):
            arrow_ipc.read_column(path)
        assert tdata.load_c4(path) is None
        assert "[INFO] c4 unavailable (ValueError)" in capsys.readouterr().out
    legacy = _write_stream(tmp_path / "legacy", pa.table({"text": text}),
                           use_legacy_format=True)
    with open(os.path.join(legacy, "data-00000-of-00001.arrow"), "rb") as f:
        assert f.read(4) != b"\xff\xff\xff\xff"
    assert list(arrow_ipc.read_column(legacy)) == ["a", "bb", None, "ccc"]
    with pytest.raises(KeyError):
        arrow_ipc.read_column(legacy, "body")
    truncated = _write_stream(tmp_path / "cut", pa.table({"text": text}))
    shard = os.path.join(truncated, "data-00000-of-00001.arrow")
    with open(shard, "rb") as f:
        raw = f.read()
    with open(shard, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(ValueError):
        list(arrow_ipc.read_column(truncated))
