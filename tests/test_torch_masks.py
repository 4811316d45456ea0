"""The port's ``masks/`` and the three mask CLIs against the JAX package's,
byte for byte on the JSON they write.

Score files are made with numpy from a seed: 12 blocks of 24 neurons, values
rounded to 2 decimals so that ties occur (the tie rule is part of the
contract), nested under ``ffn`` and ``attn/heads`` leaves, one file with a
missing key. The CLIs run in-process under both packages with the same argv.
"""

import importlib
import json
import sys

import numpy as np
import pytest

from ssp_x_vit_tpu import masks as jm
from ssp_x_vit_tpu.cli import aggregate_and_mask_summation as jsum_cli
from ssp_x_vit_tpu.cli import consensus_mask as jcons_cli
from ssp_x_vit_tpu.cli import normalize_scores as jnorm_cli
from ssp_x_vit_tpu.masks import export as jexport
from ssp_x_vit_tpu.models.vit import ViTConfig as JViTConfig
from ssp_x_vit_tpu_torch import masks as tm
from ssp_x_vit_tpu_torch.cli import aggregate_and_mask_summation as tsum_cli
from ssp_x_vit_tpu_torch.cli import consensus_mask as tcons_cli
from ssp_x_vit_tpu_torch.cli import normalize_scores as tnorm_cli
from ssp_x_vit_tpu_torch.masks import export as texport
from ssp_x_vit_tpu_torch.models.vit import ViTConfig as TViTConfig

# ``masks.conjunction`` is also the name of a function in both packages' ``masks``
jconj = importlib.import_module("ssp_x_vit_tpu.masks.conjunction")
tconj = importlib.import_module("ssp_x_vit_tpu_torch.masks.conjunction")

BLOCKS, NEURONS = 12, 24


def _leaf(seed, spread=1.0, drop=None):
    rng = np.random.default_rng(seed)
    leaf = {f"{i}:{j}": round(float(rng.random() * spread), 2)
            for i in range(BLOCKS) for j in range(NEURONS)}
    if drop is not None:
        leaf.pop(drop)
    return leaf


def _score_tree(seed, drop=None):
    return {"ffn": _leaf(seed, drop=drop), "attn": {"heads": _leaf(seed + 100, spread=5.0)},
            "note": "scores", "step": 3}


@pytest.fixture(scope="module")
def score_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scores")
    paths = []
    for name, seed, drop in (("a", 1, None), ("b", 2, "3:5"), ("c", 3, None)):
        p = d / f"{name}.json"
        p.write_text(json.dumps(_score_tree(seed, drop)))
        paths.append(p)
    return paths


def _dump_bytes(obj, path, compact=True):
    tm.dump_json_atomic(obj, path, compact=compact)
    return path.read_bytes()


def test_codec_functions_match_jax():
    tree = _score_tree(5)
    assert tm.find_leaf_ij_dicts(tree) == jm.find_leaf_ij_dicts(tree)
    leaves = dict(jm.find_leaf_ij_dicts(tree))
    assert tm.reconstruct_tree(leaves) == jm.reconstruct_tree(leaves)
    blocks_j = jm.leaf_to_arrays(tree["ffn"])
    blocks_t = tm.leaf_to_arrays(tree["ffn"])
    assert blocks_j.keys() == blocks_t.keys()
    for i in blocks_j:
        np.testing.assert_array_equal(blocks_j[i][0], blocks_t[i][0])
        np.testing.assert_array_equal(blocks_j[i][1], blocks_t[i][1])
    for as_int in (False, True):
        assert list(tm.arrays_to_leaf(blocks_t, as_int).items()) == \
            list(jm.arrays_to_leaf(blocks_j, as_int).items())
    dense = np.random.default_rng(0).random((3, 5))
    from ssp_x_vit_tpu.masks.codec import dense_scores_to_leaf as jdense
    from ssp_x_vit_tpu_torch.masks.codec import dense_scores_to_leaf as tdense
    assert list(tdense(dense).items()) == list(jdense(dense).items())
    for p in (-3.0, 0.0, 0.25, 1.0, 20.0, 100.0):
        assert tm.parse_fraction(p) == jm.parse_fraction(p)
    for name in ("floor", "round", "ceil"):
        for x in (0.5, 1.5, 2.4999, 7.2):
            assert tm.rounding_fn(name)(x) == jm.rounding_fn(name)(x)


@pytest.mark.parametrize("compact", [True, False])
def test_dump_json_atomic_bytes(tmp_path, compact):
    tree = {"ffn": _leaf(9), "é": [1, 2.5, None, True]}
    jm.dump_json_atomic(tree, tmp_path / "j.json", compact=compact)
    assert _dump_bytes(tree, tmp_path / "t.json", compact) == (tmp_path / "j.json").read_bytes()


def test_normalize_file_bytes(tmp_path, score_files):
    for src in score_files:
        assert tm.normalize_file(src, tmp_path / "t" / src.name) == \
            jm.normalize_file(src, tmp_path / "j" / src.name)
        assert (tmp_path / "t" / src.name).read_bytes() == (tmp_path / "j" / src.name).read_bytes()
    empty = tmp_path / "empty.json"
    empty.write_text('{"a": "x"}')
    assert tm.normalize_file(empty, tmp_path / "e.json") is False
    assert not (tmp_path / "e.json").exists()


@pytest.mark.parametrize("rounding", ["floor", "round", "ceil"])
@pytest.mark.parametrize("prune,per_block_k", [(0.3, None), (0.55, None), (0.0, 5), (0.2, 40)])
def test_summation_mask_bytes(tmp_path, score_files, rounding, prune, per_block_k):
    sums_t = tm.aggregate_leaves(score_files)
    sums_j = jm.aggregate_leaves(score_files)
    assert list(sums_t) == list(sums_j)
    masks_t = {p: tm.make_mask_for_leaf(leaf, prune, rounding, per_block_k)
               for p, leaf in sums_t.items()}
    masks_j = {p: jm.make_mask_for_leaf(leaf, prune, rounding, per_block_k)
               for p, leaf in sums_j.items()}
    jm.dump_json_atomic(jm.reconstruct_tree(masks_j), tmp_path / "j.json")
    assert _dump_bytes(tm.reconstruct_tree(masks_t), tmp_path / "t.json") == \
        (tmp_path / "j.json").read_bytes()
    assert _dump_bytes(tm.reconstruct_tree(sums_t), tmp_path / "ts.json") == \
        _dump_bytes(jm.reconstruct_tree(sums_j), tmp_path / "js.json")


@pytest.mark.parametrize("rounding", ["floor", "round", "ceil"])
@pytest.mark.parametrize("prune,spread_b", [
    (0.25, 1.0),   # independent files: t grows x1.2 six times, then blocks overshoot K
                   # and keep the K smallest mean scores
    (0.5, 1.0),    # larger K: three growth steps
    (0.1, -1.0),   # file b is file a reversed: the bottom sets stay disjoint until t
                   # passes 1/2 (ten growth steps)
    (0.0, 1.0),    # K = 0: the all-zero mask
])
def test_consensus_bytes(tmp_path, rounding, prune, spread_b, capsys):
    a = _leaf(11)
    b = {k: round(1.0 - v, 2) for k, v in a.items()} if spread_b < 0 else _leaf(12, drop="0:0")
    leaves = [a, b, _leaf(13)]
    mt = tm.consensus_for_path(leaves, prune, rounding, verbose=True)
    out_t = capsys.readouterr().out
    mj = jm.consensus_for_path(leaves, prune, rounding, verbose=True)
    assert capsys.readouterr().out == out_t
    jm.dump_json_atomic(mj, tmp_path / "j.json")
    assert _dump_bytes(mt, tmp_path / "t.json") == (tmp_path / "j.json").read_bytes()


@pytest.mark.parametrize("methods,target", [
    (((tconj.DepthPruning, jconj.DepthPruning), (tconj.WidthPruning, jconj.WidthPruning)), 0.3),
    (((tconj.WidthPruning, jconj.WidthPruning), (tconj.HeadPruning, jconj.HeadPruning)), 0.2),
])
@pytest.mark.parametrize("random", [True, False])
def test_mask_conjunction_matches_jax(methods, target, random):
    tdims, jdims = tconj.ModelDims(16, 4, 2, n_blocks=4), jconj.ModelDims(16, 4, 2, n_blocks=4)
    flags = [(True, True), (True, False)]
    got = tm.mask_conjunction(tdims, [(m[0], *f) for m, f in zip(methods, flags)], target,
                              random=random)
    want = jm.mask_conjunction(jdims, [(m[1], *f) for m, f in zip(methods, flags)], target,
                               random=random)
    assert got == want
    for tcls, jcls in methods:
        tp, jp = tcls(tdims, random), jcls(jdims, random)
        tp.fit(), jp.fit()
        np.testing.assert_array_equal(tp.mask_at(0.4), jp.mask_at(0.4))
        for x, y in zip(tp.mask_fc(0.4), jp.mask_fc(0.4)):
            np.testing.assert_array_equal(x, y)
    assert tm.count_pruned(np.eye(3, dtype=bool)) == jm.count_pruned(np.eye(3, dtype=bool))


@pytest.mark.parametrize("with_masks,pruned", [(True, [2, 5]), (False, [])])
def test_framework_exports_bytes(tmp_path, with_masks, pruned):
    kw = dict(image_size=32, patch_size=8, hidden_size=16, num_layers=6, num_heads=2,
              intermediate_size=24)
    rng = np.random.default_rng(4)
    mlp = [rng.random(24).astype(np.float32) for _ in range(6)]
    att = rng.random(6).astype(np.float32)
    masks = [list((rng.random(24) < 0.3).astype(int)) for _ in range(6)] if with_masks else None
    out_t = texport.build_framework_exports(str(tmp_path / "t" / "fw"), TViTConfig(**kw), mlp,
                                            att, masks, pruned)
    out_j = jexport.build_framework_exports(str(tmp_path / "j" / "fw"), JViTConfig(**kw), mlp,
                                            att, masks, pruned)
    assert out_t == out_j
    for suffix in ("_scores.json", "_masks.json"):
        assert (tmp_path / "t" / f"fw{suffix}").read_bytes() == \
            (tmp_path / "j" / f"fw{suffix}").read_bytes()


def _run_cli(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


@pytest.mark.parametrize("extra", [
    ["--prune", "30", "--rounding", "floor"], ["--prune", "0.3", "--rounding", "ceil"],
    ["--per-block-k", "7"], ["--prune", "45", "--per-block-k", "3"], ["--prune", "30", "--dry-run"],
])
def test_summation_cli_bytes(tmp_path, monkeypatch, capsys, score_files, extra):
    outs = {}
    for tag, module in (("j", jsum_cli), ("t", tsum_cli)):
        d = tmp_path / tag
        _run_cli(monkeypatch, module, [*map(str, score_files), "--mask-out", str(d / "mask.json"),
                                       "--aggregate-out", str(d / "sums.json"), *extra])
        outs[tag] = capsys.readouterr().out.replace(str(d), "<d>")
    assert outs["t"] == outs["j"]
    for name in ("mask.json", "sums.json"):
        assert (tmp_path / "t" / name).exists() == (tmp_path / "j" / name).exists()
        if (tmp_path / "j" / name).exists():
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    # the precomputed-sums path (--aggregated) gives the same mask again
    if "--dry-run" not in extra:
        _run_cli(monkeypatch, tsum_cli, ["--aggregated", str(tmp_path / "j" / "sums.json"),
                                         "--mask-out", str(tmp_path / "t2.json"), *extra])
        assert (tmp_path / "t2.json").read_bytes() == (tmp_path / "j" / "mask.json").read_bytes()


@pytest.mark.parametrize("extra", [["--prune", "25"], ["--prune", "0.5", "--rounding", "floor"],
                                   ["--prune", "10", "--rounding", "ceil"],
                                   ["--prune", "25", "--dry-run"]])
def test_consensus_cli_bytes(tmp_path, monkeypatch, capsys, score_files, extra):
    outs = {}
    for tag, module in (("j", jcons_cli), ("t", tcons_cli)):
        d = tmp_path / tag
        _run_cli(monkeypatch, module, [*map(str, score_files), "--mask-out",
                                       str(d / "mask.json"), *extra])
        outs[tag] = capsys.readouterr().out.replace(str(d), "<d>")
    assert outs["t"] == outs["j"]
    assert (tmp_path / "t" / "mask.json").exists() == ("--dry-run" not in extra)
    if "--dry-run" not in extra:
        assert (tmp_path / "t" / "mask.json").read_bytes() == \
            (tmp_path / "j" / "mask.json").read_bytes()


@pytest.mark.parametrize("mode", ["out-dir", "inplace", "beside"])
def test_normalize_cli_bytes(tmp_path, monkeypatch, capsys, score_files, mode):
    outs = {}
    for tag, module in (("j", jnorm_cli), ("t", tnorm_cli)):
        d = tmp_path / tag
        d.mkdir()
        srcs = []
        for p in score_files:
            (d / p.name).write_bytes(p.read_bytes())
            srcs.append(str(d / p.name))
        flags = {"out-dir": ["--out-dir", str(d / "norm")], "inplace": ["--inplace"],
                 "beside": []}[mode]
        _run_cli(monkeypatch, module, [*srcs, *flags])
        outs[tag] = capsys.readouterr().out.replace(str(d), "<d>")
    assert outs["t"] == outs["j"]
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "t")
                           for p in (tmp_path / "t").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
