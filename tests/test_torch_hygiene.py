"""Boundaries of the PyTorch port: it never imports JAX or the JAX package,
its entry points refuse to run without a GPU unless asked for the CPU, its
kernel modules import without nvcc, and on a card the kernels agree with
their plain versions (the ``cuda`` tests, skipped without one)."""

import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_never_import_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest), import
    every module of the port and chip_smoke.py, then look at sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import ssp_x_vit_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(ssp_x_vit_tpu_torch.__path__,
                                                       "ssp_x_vit_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                     or m == "ssp_x_vit_tpu" or m.startswith("ssp_x_vit_tpu.")
                     or m.split(".")[0] in ("pyarrow", "datasets"))
        print(len(names), bad)
        assert not bad, bad
        assert len(names) >= 45, names
        for name in ("parallel.moe", "llm.arrow_ipc", "llm.multilora", "data.native_loader",
                     "data.image_decode", "data.png", "data.pets", "utils.logging",
                     "utils.profiling", "parallel.mesh", "parallel.collectives",
                     "parallel.vit_sharding", "parallel.llm_sharding", "parallel.pipeline",
                     "parallel.ring_attention", "parallel.deepseek_parallel", "llm.aot",
                     "ops.kernels.library"):
            assert "ssp_x_vit_tpu_torch." + name in names, names
        import torch.distributed
        assert not torch.distributed.is_initialized()   # importing makes no process group
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


FORBIDDEN = ("jax", "jaxlib", "ssp_x_vit_tpu", "regex", "transformers", "tokenizers",
             "sentencepiece", "google", "safetensors", "datasets", "ml_dtypes", "torchvision",
             "PIL", "pyarrow", "pandas")


def test_no_import_statement_names_a_package_the_card_machine_lacks():
    """Every ``import`` / ``from`` statement of the port, of chip_smoke.py and of
    its ``[PARALLEL]`` runner, at any depth (a function's lazy import included), read with ``ast``:
    none names JAX, the JAX package, or a package the card's machine does not
    have (``regex``, ``transformers``, ``tokenizers``, ``sentencepiece``,
    ``google`` (protobuf), ``safetensors``, ``datasets``, ``ml_dtypes``,
    ``torchvision``, ``PIL``, ``pyarrow``, ``pandas``)."""
    import ast

    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "arrow_corpus.py"),
             os.path.join(ROOT, "scripts", "torch_parallel_phase.py"),
             os.path.join(ROOT, "scripts", "torch_aot_phase.py"),
             os.path.join(ROOT, "scripts", "torch_operator_ab.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "ssp_x_vit_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    found = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            found += [(os.path.relpath(path, ROOT), node.lineno, m) for m in mods
                      if m.split(".")[0] in FORBIDDEN]
    assert len(files) >= 45
    assert not found, found


def test_chip_smoke_fails_without_a_gpu():
    """No CUDA device here: the script exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    from ssp_x_vit_tpu_torch.cli import apply_mask_prune, auto_2ssp, grid
    from ssp_x_vit_tpu_torch.cli.common import resolve_model
    from ssp_x_vit_tpu_torch.data.pipeline import DataPipeline, load_cifar
    from ssp_x_vit_tpu_torch.data.srp import load_srp_dataset, load_srp_model
    from ssp_x_vit_tpu_torch.models.persistence import load_pruned_model
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig, init_vit_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                     num_heads=2, intermediate_size=32)
    imgs = np.zeros((2, 16, 16, 3), np.uint8)
    (tmp_path / "mask.json").write_text('{"ffn": {"0:0": 1}}')
    (tmp_path / "a.json").write_text('{"ffn": {"0:0": 0.5}}')
    (tmp_path / "b.json").write_text('{"ffn": {"0:0": 0.25}}')
    mask_args = ["--mask", str(tmp_path / "mask.json"), "--model", "tiny",
                 "--dataset", "synthetic"]
    for call in (lambda: init_vit_params(tiny),
                 lambda: resolve_model("tiny"),
                 lambda: DataPipeline(imgs, np.zeros(2, np.int32), img_size=16),
                 lambda: load_cifar("cifar10", img_size=16),
                 lambda: load_srp_dataset("cifar100", res=16),
                 lambda: load_srp_model("Ti/16", checkpoint_npz=str(tmp_path / "x.npz")),
                 lambda: load_pruned_model(os.path.join(ROOT, "ckpts", "vit_procgen")),
                 lambda: auto_2ssp.run(auto_2ssp.build_argparser().parse_args(
                     ["--model", "tiny", "--target", "0.25"])),
                 lambda: apply_mask_prune.run(apply_mask_prune.build_argparser().parse_args(
                     mask_args)),
                 lambda: grid.run_grid("summation", [tmp_path / "a.json", tmp_path / "b.json"],
                                       {2}, [20], tmp_path / "grid",
                                       apply_args=["--model", "tiny"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert init_vit_params(tiny, device="cpu")["blocks"]["fc1_kernel"].device.type == "cpu"
    assert not (tmp_path / "grid" / "logs").exists() or \
        not any((tmp_path / "grid" / "logs").iterdir())    # no subprocess was started


def test_llm_entry_points_raise_without_a_gpu(monkeypatch):
    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.llm.checkpoints import (
        llm_params_from_jax, load_llm_model, sliced_params_from_jax,
    )
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = LlamaConfig(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2, num_kv_heads=2,
                       intermediate_size=24)
    parser = main_llm.build_argparser()
    for call in (lambda: init_llama_params(None, tiny),
                 lambda: load_llm_model(os.path.join(ROOT, "ckpts", "code_llm_small")),
                 lambda: llm_params_from_jax({"embed": np.zeros((2, 2), np.float32)}),
                 lambda: sliced_params_from_jax({"embed": np.zeros((2, 2), np.float32),
                                                 "layers": []}),
                 lambda: main_llm.run(parser.parse_args(["--model", "tiny-random",
                                                         "--pruning_method", "slicegpt"])),
                 lambda: main_llm.run(parser.parse_args(["--model", "tiny-random", "--dense"])),
                 lambda: main_llm.main(["--model", "tiny-random", "--dense"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = init_llama_params(None, tiny, device="cpu")
    assert params["blocks"]["gate_kernel"].device.type == "cpu"
    # a model on the CPU handed to a run that asks for the card is refused, not moved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="--backend is cuda"):
        main_llm.run(parser.parse_args(["--model", "tiny-random", "--dense"]), model=(params, tiny))


def test_serving_entry_points_raise_without_a_gpu(monkeypatch):
    from ssp_x_vit_tpu_torch.cli import serve_http
    from ssp_x_vit_tpu_torch.llm.checkpoints import pools_from_jax
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parser = serve_http.build_argparser()
    assert parser.parse_args(["--model", "tiny-random"]).backend == "cuda"
    for call in (lambda: serve_http.build_engine(parser.parse_args(["--model", "tiny-random"])),
                 lambda: serve_http.main(["--model", "tiny-random", "--port", "0"]),
                 lambda: pools_from_jax(np.zeros((1, 2, 2, 2), np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a model on the CPU handed to an engine that asks for the card is refused, not moved
    tiny = LlamaConfig(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2, num_kv_heads=2,
                       intermediate_size=24)
    params = init_llama_params(None, tiny, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="--backend is cuda"):
        serve_http.build_engine(parser.parse_args(["--model", "x"]), model=(params, tiny))


def test_unported_serving_parts_name_the_roadmap_item(tmp_path):
    """What the serving paths refuse: a ``--tokenizer`` directory with
    neither ``tokenizer.json`` nor ``tokenizer.model`` raises ``OSError``, as
    ``AutoTokenizer`` does (every tokenizer family the JAX package reads
    through it is ported since A.10f; a tokenizer node that is not ported
    names A.10g, tests/test_torch_spm_model.py), and a config that is neither
    family raises (the DeepSeek/MLA engine is tested in
    tests/test_torch_paged_mla.py).
    Multi-LoRA (``lora_ids``, once refused naming A.10) serves: id 0 is the
    base model, id 1 its adapter (tests/test_torch_multilora.py holds it
    against the JAX package)."""
    from ssp_x_vit_tpu_torch.cli import serve_http
    from ssp_x_vit_tpu_torch.llm import serve
    from ssp_x_vit_tpu_torch.llm.engine import ServingEngine
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params

    with pytest.raises(OSError, match="neither tokenizer.json nor tokenizer.model"):
        serve_http.server_kwargs(serve_http.build_argparser().parse_args(
            ["--model", "tiny-random", "--backend", "cpu", "--tokenizer", str(tmp_path)]), None)
    tiny = LlamaConfig(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2, num_kv_heads=2,
                       intermediate_size=24)
    params = init_llama_params(None, tiny, device="cpu")
    from ssp_x_vit_tpu_torch.llm.lora import init_lora, merge_lora
    from ssp_x_vit_tpu_torch.llm.multilora import attach_lora_bank, build_lora_bank

    adapter = init_lora(torch.Generator().manual_seed(1), params, rank=2)
    for ab in adapter.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=torch.Generator().manual_seed(2))
    served = attach_lora_bank(params, build_lora_bank([adapter]))
    got = serve.generate_kv_scan(served, tiny, [[1, 2, 3]] * 2, max_length=8, lora_ids=[0, 1],
                                 cache_dtype=torch.float32)
    for row, tree in zip(got, (params, merge_lora(params, adapter))):
        np.testing.assert_array_equal(row, serve.generate_kv_scan(
            tree, tiny, [1, 2, 3], max_length=8, cache_dtype=torch.float32))
    with pytest.raises(TypeError, match="LlamaConfig"):
        ServingEngine({}, object())   # neither a LlamaConfig nor a DeepseekConfig


def test_unported_cli_flags_name_the_roadmap_item(tmp_path, monkeypatch, capsys):
    """The ViT flags once refused naming their items now run. An
    Oxford-IIIT-Pet directory on disk (once A.7d) loads: the committed
    fixtures' test split, decoded by the port's own reader. --data-parallel
    (once A.11d): in one process on the CPU it is a no-op, as the JAX CLI on
    one device (the same report, no data-parallel line); run() in one process
    with more than one CUDA device (faked here, the check comes before any
    CUDA work) refuses, naming the launchers, since the workers are
    processes (tests/test_torch_parallel_mesh.py runs a world of two)."""
    from ssp_x_vit_tpu_torch.cli import auto_2ssp
    from ssp_x_vit_tpu_torch.data.srp import load_srp_dataset

    test = load_srp_dataset("oxford-iiit-pet", root=os.path.join(ROOT, "tests", "fixtures", "pets"),
                            res=32, batch_size=4, device="cpu")
    assert test.images.shape == (10, 32, 32, 3) and test.images.dtype == np.uint8
    assert sorted(test.labels.tolist()) == [1, 3, 4, 8, 10, 13, 16, 25, 29, 36]
    assert next(iter(test))["pixel_values"].shape == (4, 32, 32, 3)
    base = ["--model", "tiny", "--target", "0.25", "--backend", "cpu", "--eval-batches", "1",
            "--min-remaining", "32"]
    reports = [auto_2ssp.run(auto_2ssp.build_argparser().parse_args(
        base + flags + ["--out-root", str(tmp_path / str(len(flags)))]))
        for flags in ([], ["--data-parallel"])]
    assert "Data-parallel" not in capsys.readouterr().out
    assert reports[0]["metrics"]["acc_stage2"] == reports[1]["metrics"]["acc_stage2"]
    assert reports[0]["artifacts"]["pruned_block_indices"] == \
        reports[1]["artifacts"]["pruned_block_indices"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = auto_2ssp.build_argparser().parse_args(["--model", "tiny", "--target", "0.25",
                                                   "--data-parallel"])
    with pytest.raises(ValueError, match=r"one process per device.*torchrun"):
        auto_2ssp.run(args)


def test_unported_llm_flags_name_the_roadmap_item(tmp_path):
    """--local_datasets (once refused naming A.10a) runs: with a model that is
    not a directory it takes the synthetic streams, as the JAX CLI does
    (tests/test_torch_local_corpora.py reads real ./data corpora); the
    DeepSeek models (the two tiny names and a native directory with
    kv_lora_rank) load and run."""
    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.llm import deepseek

    base = ["--backend", "cpu", "--model", "tiny-random"]
    out = main_llm.run(main_llm.build_argparser().parse_args(
        base + ["--local_datasets", "--dense", "--evaluate_perplexity", "--seq-len", "32",
                "--num-calibration", "1"]))
    assert out["corpora"] == "synthetic" and np.isfinite(out["dense"]["ppl"])
    for model in ("tiny-random-deepseek", "tiny-random-deepseek-dense"):
        args = main_llm.build_argparser().parse_args(["--backend", "cpu", "--model", model])
        params, cfg = main_llm.load_model(args, torch.device("cpu"))
        assert isinstance(cfg, deepseek.DeepseekConfig)
        assert ("moe_blocks" in params) == (model == "tiny-random-deepseek")
    deepseek.save_deepseek_model(str(tmp_path / "mla"), params, cfg)
    assert '"kv_lora_rank": 32' in (tmp_path / "mla" / "config.json").read_text()
    out = main_llm.run(main_llm.build_argparser().parse_args(
        ["--backend", "cpu", "--model", str(tmp_path / "mla"), "--dense", "--evaluate_perplexity",
         "--synthetic-data", "--seq-len", "16", "--num-calibration", "1"]))
    assert out["model_type"] == "deepseek_v3" and np.isfinite(out["dense"]["ppl"])


def test_llm_kernel_wrappers_check_their_operands():
    """What the wrappers refuse before any launch, reachable without a card:
    the plain versions run for CPU tensors, other devices raise."""
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa
    from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

    assert KERNEL_NAMES[4:7] == ("flash_attention", "quant4_matmul", "quant_matmul")
    reset_launch_counts()
    q = torch.zeros(1, 2, 8, 16)
    assert tfa.flash_attention(q, q, q, causal=True).shape == q.shape
    w = torch.zeros(8, 4, dtype=torch.int8)
    assert tqm.quant_matmul(torch.zeros(3, 8), w, torch.ones(4)).shape == (3, 4)
    assert tqm.quant4_matmul(torch.zeros(3, 16), w, torch.ones(4)).shape == (3, 4)
    assert all(n == 0 for n in launch_counts.values())  # CPU tensors launch nothing
    meta = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tfa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tqm.quant4_matmul(torch.zeros(3, 16, device="meta"), w, torch.ones(4))


def test_paged_kernel_wrappers_check_their_operands(monkeypatch):
    """CPU tensors take the plain versions and launch nothing; other devices
    raise; and what the wrappers refuse before a launch (dtype, contiguity,
    int32 tables, pool rank, host layer index) raises for tensors that claim
    to be on the card (``dispatch.use_kernel`` patched: no launch is reached)."""
    from ssp_x_vit_tpu_torch.ops import dispatch
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    assert KERNEL_NAMES[-7:-1] == ("paged_attention", "paged_attention_q8", "paged_pool_write",
                                   "paged_pool_write_q8", "paged_attention_write",
                                   "paged_attention_write_q8")
    reset_launch_counts()
    b, nq, nkv, hd, ps, P, mp = 2, 4, 2, 8, 4, 5, 2
    q, new = torch.zeros(b, nq, hd), torch.ones(b, nkv, hd)
    pool = torch.zeros(nkv, P, ps, hd)
    pool8 = {"q": torch.zeros(nkv, P, ps, hd, dtype=torch.int8), "s": torch.ones(nkv, P, ps)}
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    assert tpa.paged_attention(q, pool, pool, table, lens).shape == q.shape
    assert tpa.paged_attention(q, pool8, pool8, table, lens).shape == q.shape
    assert tpa.paged_cache_write(pool, pool.clone(), new, new, table, lens)[0] is pool
    assert pool[:, 1, 3].eq(1).all() and pool[:, 4, 1].eq(1).all() and pool.sum() == 2 * nkv * hd
    tpa.paged_pool_write(pool8, new, table, lens)
    assert pool8["q"][:, 1, 3].eq(127).all() and pool8["s"][0, 1, 3].item() == np.float32(1) / np.float32(127)
    assert all(n == 0 for n in launch_counts.values())
    meta = torch.zeros(b, nq, hd, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tpa.paged_attention(meta, pool, pool, table, lens)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tpa.paged_cache_write(pool, pool, meta[:, :nkv], meta[:, :nkv], table, lens)

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)

    def attend(**kw):
        return tpa.paged_attention(**{**dict(q=q, k_pages=pool, v_pages=pool, page_table=table,
                                             seq_lens=lens), **kw})

    def write(**kw):
        return tpa.paged_cache_write(**{**dict(k_pages=pool, v_pages=pool, k_new=new, v_new=new,
                                               page_table=table, positions=lens), **kw})

    pool5 = pool[None]
    for call, kw, exc, match in (
            (attend, dict(q=q.double()), TypeError, "float32 or bfloat16"),
            (attend, dict(q=q.transpose(0, 1)), ValueError, "contiguous"),
            (attend, dict(page_table=table.long()), TypeError, "page_table must be int32"),
            (attend, dict(seq_lens=lens.long()), TypeError, "seq_lens must be int32"),
            (attend, dict(start_lens=lens[:1]), ValueError, "start_lens has shape"),
            (attend, dict(page_table=table.t()), ValueError, "page_table"),
            (attend, dict(k_pages=pool5), ValueError, "4D pool"),
            (attend, dict(layer_idx=0), ValueError, "5D pool"),
            (attend, dict(k_pages=pool5, v_pages=pool5, layer_idx=1), ValueError, "host integer"),
            (attend, dict(k_pages=pool5, v_pages=pool5, layer_idx=torch.tensor(0)), ValueError,
             "host integer"),
            (attend, dict(k_pages=pool.bfloat16(), v_pages=pool.bfloat16()), TypeError,
             "a float pool has q's dtype"),
            (attend, dict(k_pages=pool8, v_pages=pool8), TypeError, "computes in bfloat16"),
            (attend, dict(k_pages=pool8), TypeError, "both be float pools or both int8"),
            (attend, dict(k_pages={"q": pool8["q"], "s": pool8["s"].double()}, v_pages=pool8),
             TypeError, "int8 codes and float32 scales"),
            (attend, dict(k_pages=pool[..., :4], v_pages=pool[..., :4]), ValueError, "contiguous"),
            (attend, dict(q=torch.zeros(b, 3, hd)), ValueError, "multiple of nkv"),
            (attend, dict(q=torch.zeros(b, 18, hd)), ValueError, "at most 8"),
            (write, dict(k_new=new.double()), TypeError, "float32 or bfloat16"),
            (write, dict(v_new=new.transpose(1, 2).contiguous().transpose(1, 2)), ValueError,
             "contiguous"),
            (write, dict(positions=lens.long()), TypeError, "positions must be int32"),
            (write, dict(page_table=table.long()), TypeError, "page_table must be int32"),
            (write, dict(k_new=torch.ones(b, nkv, hd + 1), v_new=torch.ones(b, nkv, hd + 1)),
             ValueError, "do not fit"),
            (write, dict(v_pages=pool8), TypeError, "both be float pools or both int8"),
            (write, dict(layer_idx=0), ValueError, "5D pool")):
        with pytest.raises(exc, match=match):
            call(**kw)
    assert all(n == 0 for n in launch_counts.values())


def test_write_attend_wrapper_refuses_what_the_two_wrappers_refuse(monkeypatch):
    """``paged_attention_write`` (the decode layer's one call) raises, before
    any launch, for every operand the write and the attention refuse, and a
    signature it has seen is checked again for what can change between calls
    of one signature: contiguity and the host layer index
    (``dispatch.use_kernel`` and the launch patched, tensors on the CPU)."""
    from ssp_x_vit_tpu_torch.ops import dispatch
    from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts, reset_launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    reset_launch_counts()
    b, nq, nkv, hd, ps, P = 2, 4, 2, 8, 4, 5
    q, new = torch.zeros(b, nq, hd), torch.ones(b, nkv, hd)
    pool = torch.zeros(nkv, P, ps, hd)
    pool8 = {"q": torch.zeros(nkv, P, ps, hd, dtype=torch.int8), "s": torch.ones(nkv, P, ps)}
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    out = tpa.paged_attention_write(q, new, new, pool, pool.clone(), table, pos)
    assert out.shape == q.shape and pool[:, 1, 3].eq(1).all() and pool[:, 4, 1].eq(1).all()
    assert all(n == 0 for n in launch_counts.values())
    meta = torch.zeros(b, nq, hd, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tpa.paged_attention_write(meta, new, new, pool, pool, table, pos)

    launched = []
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(build, "paged_attention_write", lambda *a, **k: launched.append(k))
    monkeypatch.setattr(build, "raw_stream", lambda index: 0)
    monkeypatch.setattr(tpa, "_sm_count", lambda device: 132)
    monkeypatch.setattr(build, "workspace", lambda index, n: torch.zeros(n))
    monkeypatch.setattr(build, "tickets", lambda device, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)  # a CPU tensor's get_device()

    def call(**kw):
        return tpa.paged_attention_write(**{**dict(
            q=q, k_new=new, v_new=new, k_pages=pool, v_pages=pool, page_table=table,
            positions=pos), **kw})

    pool5 = pool[None]
    for kw, exc, match in (
            (dict(q=q.double()), TypeError, "float32 or bfloat16"),
            (dict(q=q.transpose(0, 1)), ValueError, "contiguous"),
            (dict(page_table=table.long()), TypeError, "page_table must be int32"),
            (dict(positions=pos.long()), TypeError, "positions must be int32"),
            (dict(start_lens=pos[:1]), ValueError, "start_lens has shape"),
            (dict(page_table=table.t()), ValueError, "page_table"),
            (dict(k_pages=pool5), ValueError, "4D pool"),
            (dict(layer_idx=0), ValueError, "5D pool"),
            (dict(k_pages=pool5, v_pages=pool5, layer_idx=1), ValueError, "host integer"),
            (dict(k_pages=pool5, v_pages=pool5, layer_idx=torch.tensor(0)), ValueError,
             "host integer"),
            (dict(k_pages=pool.bfloat16(), v_pages=pool.bfloat16()), TypeError,
             "a float pool has q's dtype"),
            (dict(k_pages=pool8, v_pages=pool8), TypeError, "computes in bfloat16"),
            (dict(k_pages=pool8), TypeError, "both be float pools or both int8"),
            (dict(q=q.bfloat16(), k_pages={"q": pool8["q"], "s": pool8["s"].double()},
                  v_pages=pool8), TypeError, "int8 codes and float32 scales"),
            (dict(k_pages=pool[..., :4], v_pages=pool[..., :4]), ValueError, "contiguous"),
            (dict(q=torch.zeros(b, 3, hd)), ValueError, "multiple of nkv"),
            (dict(q=torch.zeros(b, 18, hd)), ValueError, "at most 8"),
            (dict(k_new=new.double()), TypeError, "float32 or bfloat16"),
            (dict(v_new=new.transpose(1, 2).contiguous().transpose(1, 2)), ValueError,
             "contiguous"),
            (dict(k_new=torch.ones(b, nkv, hd + 1), v_new=torch.ones(b, nkv, hd + 1)),
             ValueError, "do not fit")):
        with pytest.raises(exc, match=match):
            call(**kw)
    assert not launched
    # a signature seen once: its next calls still refuse what can change between calls
    call()
    call(k_pages=pool5, v_pages=pool5, layer_idx=0)
    assert len(launched) == 2 and launched[1]["layer"] == 0
    for kw, exc, match in (
            (dict(q=q.transpose(1, 2).contiguous().transpose(1, 2)), ValueError, "contiguous"),
            (dict(k_pages=pool5, v_pages=pool5, layer_idx=1), ValueError, "host integer"),
            (dict(k_pages=pool5, v_pages=pool5, layer_idx=-1), ValueError, "host integer")):
        with pytest.raises(exc, match=match):
            call(**kw)
    assert len(launched) == 2
    assert launch_counts["paged_attention_write"] == 2


def test_kernel_modules_import_and_build_needs_nvcc(monkeypatch, tmp_path):
    """The kernel modules import without nvcc; building without it raises."""
    from ssp_x_vit_tpu_torch.ops.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(build, "_libraries", {})
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this machine has nvcc at /usr/local/cuda")
    assert set(build.SOURCES) == {"gemm", "attention", "flash_attention", "flash_attention_bwd",
                                  "quant_gemm", "paged_attention", "quant_fused_mlp",
                                  "paged_mla", "paged_mla_hopper"}
    assert set(build.SIGNATURES) == set(build.SOURCES)
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.library(name)


def test_dispatch_is_decided_by_the_tensor_device():
    """CPU tensors take the plain version, CUDA tensors the kernel, and any
    other device raises instead of falling back."""
    from ssp_x_vit_tpu_torch.ops import dispatch

    assert dispatch.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        dispatch.use_kernel(torch.zeros(1, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda tests/test_torch_hygiene.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_kernels_match_plain_versions_on_the_card(cuda_device, dtype, tol):
    """Rows 1-4 against their plain versions at a ragged small shape
    (b=3, s=65, f=1000, 3 heads: split-K GEMMs, 16-row query tiles);
    tolerance on max |diff| / max(1, max |plain|)."""
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffk

    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda_device) * std).to(dtype)

    def check(got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        assert err / max(1.0, ref.float().abs().max().item()) <= tol

    # f=1000 and d=96 keep K deep enough for the split-K path at this small batch
    b, s, d, f = 3, 65, 96, 1000
    x = rn(b, s, d)
    attn = [rn(d, std=0.1) + 1, rn(d, std=0.1), rn(d, 3 * d, std=d ** -0.5), rn(3 * d, std=0.1),
            rn(d, d, std=d ** -0.5), rn(d, std=0.1)]
    gate = torch.full((), 0.5, device=cuda_device)
    for name, heads in (("fused_attn_block_v2", 4), ("fused_attn_block", 3)):
        check(getattr(fab, name)(x, *attn, heads, gate=gate),
              getattr(fab, name + "_plain")(x, *attn, heads, gate=gate))
    w = [rn(d, f, std=d ** -0.5), rn(f, std=0.1), rn(f, d, std=f ** -0.5), rn(d, std=0.1)]
    mask = (torch.rand(f, generator=gen, device=cuda_device) > 0.3).float()
    for got, ref in ((ffk.fused_ffn_block(x, attn[0], attn[1], *w, neuron_mask=mask, gate=gate,
                                          collect_stats=True),
                      ffk.fused_ffn_block_plain(x, attn[0], attn[1], *w, neuron_mask=mask,
                                                gate=gate, collect_stats=True)),
                     (ffk.fused_ffn(x, *w, neuron_mask=mask, collect_stats=True),
                      ffk.fused_ffn_plain(x, *w, neuron_mask=mask, collect_stats=True))):
        check(got[0], ref[0])
        assert (got[1] - ref[1]).abs().max().item() <= tol * ref[1].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_vit_gemm_and_core_at_their_edges_on_the_card(cuda_device, dtype, tol):
    """The ViT block GEMM (csrc/gemm.cu) against gemm_plain where its tiles
    change course: M = 1, 197, 300 and 12608 rows (split-K at the small ones),
    (K, N) = (192, 576), (768, 2305) and (682, 250) (element loads where K or
    N is not a multiple of 8), an A one element off 16 bytes; each epilogue
    (the bias one with and without a gate), GELU with the mask and the stats
    over images of 197, 25 or 1 rows; the same bits on a second launch
    without stats. The attention core
    (csrc/attention.cu) against attention_core_plain at s = 1, 65, 197, 257
    and 300 and head_dim 32, 64, 128 (fp32: where a head's K and V fit in
    shared memory), by the scaled error and by flash_agrees on the
    [b, h, s, hd] views. Tolerance on max |diff| /
    max(1, max |plain|); stats on their own max."""
    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels.flash_attention import flash_agrees, flash_errors
    from ssp_x_vit_tpu_torch.ops.kernels.fused_ffn import gemm_plain

    gen = torch.Generator(device=cuda_device).manual_seed(4)

    def rn(*shape, std=1.0, offset=False):
        t = (torch.randn(math.prod(shape) + offset, generator=gen, device=cuda_device) * std).to(dtype)
        return t[offset:].view(*shape)

    def scaled(got, ref):
        return (got.float() - ref.float()).abs().max().item() / max(1.0, ref.float().abs().max().item())

    for m in (1, 197, 300, 12608):
        seq = 197 if m % 197 == 0 else 25 if m % 25 == 0 else m
        for k, n in ((192, 576), (768, 2305), (682, 250)):
            w, bias = rn(k, n, std=k ** -0.5), rn(n, std=0.1)
            resid, gate = rn(m, n), torch.full((), 0.5, device=cuda_device)
            mask = (torch.rand(n, generator=gen, device=cuda_device) > 0.3).float()
            for offset in (False, True):
                a = rn(m, k, offset=offset)
                for epi, kw in ((build.EPI_BIAS, {}), (build.EPI_BIAS, dict(gate=gate)),
                                (build.EPI_GELU, dict(mask=mask)),
                                (build.EPI_RESIDUAL, dict(resid=resid, gate=gate))):
                    got = torch.empty(m, n, device=cuda_device, dtype=dtype)
                    stats = torch.empty(m // seq, n, device=cuda_device) if epi == build.EPI_GELU else None
                    build.gemm(a, w, got, epi, bias=bias, stats=stats, seq=seq, **kw)
                    again = build.gemm(a, w, torch.empty_like(got), epi, bias=bias, seq=seq, **kw)
                    ref, ref_stats = gemm_plain(a, w, epi, bias=bias, seq=seq,
                                                collect_stats=stats is not None, **kw)
                    what = f"m={m} k={k} n={n} epi={epi} off16={offset}"
                    assert torch.equal(got, again), what
                    assert scaled(got, ref) <= tol, (what, scaled(got, ref))
                    if stats is not None:
                        s_err = (stats - ref_stats).abs().max().item() / ref_stats.abs().max().item()
                        assert s_err <= tol, (what, s_err)
    b, heads = 2, 3
    for s in (1, 65, 197, 257, 300):
        for hd in (32, 64, 128):
            if build.attention_smem_bytes(dtype, s, hd) > fab.SMEM_LIMIT_BYTES:
                # the fp32 kernel holds a head's K and V in shared memory: past
                # 227 KB (s >= 257 at head_dim 128) the wrappers refuse the shape
                assert dtype == torch.float32 and hd == 128 and s >= 257, (s, hd)
                continue
            qkv = rn(b * s, 3 * heads * hd)
            got = build.attention(qkv, torch.empty(b * s, heads * hd, device=cuda_device, dtype=dtype),
                                  b, s, heads, hd, hd ** -0.5)
            ref = fab.attention_core_plain(qkv, b, s, heads)
            assert scaled(got, ref) <= tol, (s, hd, scaled(got, ref))
            got_v, ref_v = (fab.head_view(t, b, s, heads) for t in (got, ref))
            assert flash_agrees(got_v, ref_v), (s, hd, flash_errors(got_v, ref_v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_llm_kernels_match_plain_versions_on_the_card(cuda_device, dtype, tol):
    """flash_attention (forward, and backward under autograd), quant4_matmul
    and quant_matmul against their plain versions at ragged small shapes
    (GQA, window, softcap, head_dim 80 and 40;
    K and N off the tile and off the 16-byte copies, M = 1 with split-K);
    tolerance on max |diff| / max(1, max |plain|)."""
    from ssp_x_vit_tpu_torch.ops.attention import flash_attention
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda_device) * std).to(dtype)

    def check(got, ref):
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err / max(1.0, ref.float().abs().max().item()) <= tol, err

    before = dict(launch_counts)
    cases = [  # b, h, hkv, s, hd, causal, window, softcap
        (2, 4, 2, 197, 64, True, None, None),
        (1, 4, 4, 130, 32, False, None, None),
        (1, 8, 4, 300, 80, True, 70, None),
        (1, 4, 2, 257, 256, True, None, 50.0),
        (2, 2, 1, 150, 40, True, 64, 30.0),
        (1, 2, 2, 65, 20, True, 1, None),
    ]
    for b, h, hkv, s, hd, causal, window, softcap in cases:
        kw = dict(causal=causal, window=window, softcap=softcap)
        q, k, v = rn(b, h, s, hd), rn(b, hkv, s, hd), rn(b, hkv, s, hd)
        check(flash_attention(q, k, v, **kw), tfa.flash_attention_plain(q, k, v, **kw))
        # under autograd: the forward with lse, then the dq and dk/dv kernels
        g = rn(b, h, s, hd)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, g)
        for a, r in zip(got, tfa.flash_attention_backward_plain(q, k, v, g, **kw)):
            check(a, r)

    for m, k, n in ((300, 512, 384), (1, 4096, 512), (70, 250, 200), (129, 1030, 136)):
        x = rn(m, k)
        w = rn(k, n, std=0.05).float()
        w_p, s4 = tqm.quantize_weight_int4(w)
        check(tqm.quant4_matmul(x, w_p, s4), tqm.quant4_matmul_plain(x, w_p, s4))
        w_q = torch.randint(-127, 128, (k, n), generator=gen, device=cuda_device).to(torch.int8)
        s8 = torch.rand(n, generator=gen, device=cuda_device) * 0.01 + 0.001
        check(tqm.quant_matmul(x, w_q, s8), tqm.quant_matmul_plain(x, w_q, s8))
    assert launch_counts["flash_attention"] - before["flash_attention"] == 2 * len(cases)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert launch_counts[name] - before[name] == len(cases)
    assert launch_counts["quant4_matmul"] - before["quant4_matmul"] == 4
    assert launch_counts["quant_matmul"] - before["quant_matmul"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_at_query_offsets_on_the_card(cuda_device, dtype):
    """Row 5 with ``q_offset`` (a ring hop over an earlier key chunk): output
    and lse against ``flash_attention_plain(q_offset=, with_lse=True)`` at head
    dims 64 / 80 / 128 / 256, GQA, causal and windowed bands (one that leaves
    late rows no key: output 0, lse -inf on the same rows), softcap and ragged
    lengths; an offset one chunk off is rejected. Offset 0 is the existing
    kernel (``test_flash_kernels_hold_every_row_on_the_card``)."""
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    cases = [(64, 4, 2, 200, 100, None, None), (128, 8, 8, 256, 256, 300, 50.0),
             (80, 4, 1, 130, 64, None, None), (256, 2, 1, 128, 128, 128, None),
             (128, 4, 4, 192, 96, 200, None)]   # hd, h, hkv, s, offset, window, softcap
    for hd, h, hkv, s, off, window, cap in cases:
        q = torch.randn(1, h, s, hd, generator=gen, device=cuda_device).to(dtype)
        k, v = (torch.randn(1, hkv, s, hd, generator=gen, device=cuda_device).to(dtype)
                for _ in range(2))
        kw = dict(causal=True, window=window, softcap=cap)
        out, lse = tfa.flash_attention_forward(q, k, v, with_lse=True, q_offset=off, **kw)
        ref, ref_lse = tfa.flash_attention_plain(q, k, v, q_offset=off, with_lse=True, **kw)
        assert tfa.flash_agrees(out, ref), (hd, off, tfa.flash_errors(out, ref))
        assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse)), (hd, off)
        fin = torch.isfinite(ref_lse)
        assert (lse - ref_lse)[fin].abs().max().item() <= 1e-3, (hd, off)
        if window == 128:
            assert torch.isinf(ref_lse).any() and not torch.isinf(ref_lse).all()
            assert not out[torch.isinf(ref_lse)].any()
        far = tfa.flash_attention_forward(q, k, v, q_offset=off + s // 2, **kw)[0]
        assert not tfa.flash_agrees(far, ref), (hd, off)
    with pytest.raises(ValueError, match="q_offset"):
        tfa.flash_attention_forward(q, k, v, causal=True, q_offset=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_hold_every_row_on_the_card(cuda_device, dtype):
    """The flash forward, and its backward under autograd, against the plain
    versions by both ``flash_errors`` criteria (and the scaled error) at head
    dims 20-256, s = 1 to 257, query groups of 1, 4 and 8, windows that empty
    whole key tiles, softcap and q one element off 16 bytes (the element-load
    producer); the same bits on a second run and one launch per call. Then the
    criteria's teeth at the Llama-2-7B shape: a copy of the plain output with
    a late query tile zeroed, and one with two heads swapped, is rejected, and
    so are such copies of dq, dk and dv."""
    from ssp_x_vit_tpu_torch.ops.attention import flash_attention
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tol = 1e-4 if dtype == torch.float32 else 3e-2

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)

    def off16(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view_as(t)
        out.copy_(t)
        return out

    def check(got, ref):
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err / max(1.0, ref.float().abs().max().item()) <= tol, err
        assert tfa.flash_agrees(got, ref), tfa.flash_errors(got, ref)

    cases = [  # b, h, hkv, s, hd, causal, window, softcap
        (1, 8, 1, 63, 20, True, None, None),
        (2, 4, 1, 65, 32, True, 16, None),
        (1, 4, 4, 129, 40, False, None, 30.0),
        (1, 8, 2, 257, 64, True, 100, None),
        (1, 4, 4, 1, 80, True, None, None),
        (2, 8, 8, 257, 128, True, None, 50.0),
        (1, 4, 1, 129, 256, True, 64, 50.0),
        (1, 2, 2, 65, 128, False, None, None),
    ]
    for b, h, hkv, s, hd, causal, window, softcap in cases:
        kw = dict(causal=causal, window=window, softcap=softcap)
        q, k, v, g = rn(b, h, s, hd), rn(b, hkv, s, hd), rn(b, hkv, s, hd), rn(b, h, s, hd)
        ref = tfa.flash_attention_plain(q, k, v, **kw)
        before = dict(launch_counts)
        got = flash_attention(q, k, v, **kw)
        assert launch_counts["flash_attention"] - before["flash_attention"] == 1
        check(got, ref)
        assert torch.equal(flash_attention(q, k, v, **kw), got)
        check(flash_attention(off16(q), k, v, **kw), ref)
        refs = tfa.flash_attention_backward_plain(q, k, v, g, **kw)
        runs = []
        for make_q in (q.clone, q.clone, lambda: off16(q)):
            leaves = [make_q().requires_grad_(), k.clone().requires_grad_(), v.clone().requires_grad_()]
            before = dict(launch_counts)
            runs.append(torch.autograd.grad(flash_attention(*leaves, **kw), leaves, g))
            for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                assert launch_counts[name] - before[name] == 1, name
        for grads in runs:  # twice aligned, then q off 16 bytes
            for a, r in zip(grads, refs):
                check(a, r)
        for a, again in zip(runs[0], runs[1]):
            assert torch.equal(a, again)

    # the criteria's teeth at the Llama-2-7B shape (also phase_flash_backward's first)
    q, k, v, g = (rn(1, 32, 2048, 128) for _ in range(4))
    plain = [tfa.flash_attention_plain(q, k, v, causal=True),
             *tfa.flash_attention_backward_plain(q, k, v, g, causal=True)]
    for ref in plain:
        zeroed, swapped = ref.clone(), ref.clone()
        zeroed[:, :, 1920:1984] = 0
        swapped[:, [0, 1]] = ref[:, [1, 0]]
        assert tfa.flash_agrees(ref.clone(), ref)
        assert not tfa.flash_agrees(zeroed, ref)
        assert not tfa.flash_agrees(swapped, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tol", [("float32", 1e-4), ("bfloat16", 3e-2), ("int8", 3e-2)])
def test_paged_kernels_match_plain_versions_on_the_card(cuda_device, kind, tol):
    """Rows 7-9 at small ragged shapes (4D and 5D pools, GQA groups of 1, 3
    and 8, head_dim 20 to 256, page sizes off a power of two, windows,
    softcap, one-key rows), then at the key-run edges of the split plan (1,
    ps - 1, ps, ps + 1, a run - 1, a run and a run + 1 keys, and a window
    that starts inside a run with empty runs before and after it): the write
    leaves pools identical to the plain write (int8 codes and scales bit for
    bit), the attention stays within ``tol`` of max(1, max |plain|) and gives
    the same bits on a second call; one launch per wrapper call."""
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    suffix = "_q8" if kind == "int8" else ""
    before = dict(launch_counts)
    cases = [  # b, nq, nkv, hd, ps, mp, layers, softcap, window
        (3, 4, 4, 64, 16, 4, None, None, None),
        (2, 6, 2, 40, 12, 5, 3, 30.0, 17),
        (4, 8, 1, 128, 8, 6, 2, None, None),
        (1, 4, 2, 256, 5, 7, None, 50.0, 9),
        (5, 2, 2, 20, 3, 9, None, None, 1),
        (2, 32, 8, 80, 64, 2, 2, None, 100),
    ]

    def clone(p):
        return {k: v.clone() for k, v in p.items()} if isinstance(p, dict) else p.clone()

    for b, nq, nkv, hd, ps, mp, layers, softcap, window in cases:
        lead = () if layers is None else (layers,)
        layer = None if layers is None else layers - 1
        P = 1 + b * mp
        shape = lead + (nkv, P, ps, hd)

        def pool():
            vals = torch.randn(shape, generator=gen, device=cuda_device)
            if kind == "int8":
                codes, sc = tpa.quantize_token_kv(vals)
                return {"q": codes, "s": sc}
            return vals.to(dtype)

        kp, vp = pool(), pool()
        table = (1 + torch.randperm(P - 1, generator=gen, device=cuda_device)[: b * mp]
                 ).reshape(b, mp).to(torch.int32)
        lens = torch.randint(0, mp * ps - 1, (b,), generator=gen, device=cuda_device).to(torch.int32)
        lens[0] = 0
        starts = None if window is None else (lens + 1 - window).clamp_min(0).to(torch.int32)
        q = torch.randn(b, nq, hd, generator=gen, device=cuda_device).to(dtype)
        k_new = torch.randn(b, nkv, hd, generator=gen, device=cuda_device).to(dtype)
        v_new = torch.randn(b, nkv, hd, generator=gen, device=cuda_device).to(dtype)
        k_new[0, 0] = 0  # a zero row: scale 1, codes 0
        k_ref, v_ref = clone(kp), clone(vp)
        tpa.paged_cache_write(kp, vp, k_new, v_new, table, lens, layer)
        tpa.paged_pool_write_plain(k_ref, k_new, table, lens, layer)
        tpa.paged_pool_write_plain(v_ref, v_new, table, lens, layer)
        for got, ref in ((kp, k_ref), (vp, v_ref)):
            leaves = zip(got.values(), ref.values()) if isinstance(got, dict) else [(got, ref)]
            assert all(torch.equal(g, r) for g, r in leaves)
        got = tpa.paged_attention(q, kp, vp, table, lens + 1, starts, softcap, layer)
        again = tpa.paged_attention(q, kp, vp, table, lens + 1, starts, softcap, layer)
        ref = tpa.paged_attention_plain(q, kp, vp, table, lens + 1, starts, softcap, layer)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all() and torch.equal(got, again)
        err = (got.float() - ref.float()).abs().max().item()
        assert err / max(1.0, ref.float().abs().max().item()) <= tol, (err, hd, ps)
    for name in ("paged_attention", "paged_pool_write"):
        n = 2 if name == "paged_attention" else 1
        assert launch_counts[name + suffix] - before[name + suffix] == n * len(cases)

    # one pool alone (the single-pool form); an fp32 query against int8 pools is refused
    single = torch.zeros(2, 3, 4, 8, device=cuda_device, dtype=dtype)
    tpa.paged_pool_write(single, torch.ones(1, 2, 8, device=cuda_device, dtype=dtype),
                         torch.tensor([[2]], dtype=torch.int32, device=cuda_device),
                         torch.tensor([1], dtype=torch.int32, device=cuda_device))
    assert single[:, 2, 1].eq(1).all() and single.sum().item() == 16
    if kind == "int8":
        with pytest.raises(TypeError, match="computes in bfloat16"):
            tpa.paged_attention(q.float(), kp, vp, table, lens + 1, None, None, layer)

    # the split plan's edges: b sequences of a 32-page table, keys = lens + 1
    b, nq, nkv, hd, ps, mp = 8, 8, 8, 64, 16, 32
    plan = tpa.split_plan(b, nkv, nq, hd, ps, mp, tpa._sm_count(cuda_device))
    run = plan.pages_per_split * ps
    assert plan.splits > 2, plan
    P = 1 + b * mp
    kp = tpa.quantize_token_kv(torch.randn(nkv, P, ps, hd, generator=gen, device=cuda_device))
    vp = tpa.quantize_token_kv(torch.randn(nkv, P, ps, hd, generator=gen, device=cuda_device))
    if kind == "int8":
        kp, vp = {"q": kp[0], "s": kp[1]}, {"q": vp[0], "s": vp[1]}
    else:
        kp = torch.randn(nkv, P, ps, hd, generator=gen, device=cuda_device).to(dtype)
        vp = torch.randn(nkv, P, ps, hd, generator=gen, device=cuda_device).to(dtype)
    table = (1 + torch.randperm(P - 1, generator=gen, device=cuda_device)[: b * mp]
             ).reshape(b, mp).to(torch.int32)
    keys = torch.tensor([1, ps - 1, ps, ps + 1, run - 1, run, run + 1, 2 * run + 5],
                        dtype=torch.int32, device=cuda_device)
    q = torch.randn(b, nq, hd, generator=gen, device=cuda_device).to(dtype)
    for starts in (None, (keys - (run // 2 + 3)).clamp_min(0).to(torch.int32)):
        got = tpa.paged_attention(q, kp, vp, table, keys, starts)
        again = tpa.paged_attention(q, kp, vp, table, keys, starts)
        ref = tpa.paged_attention_plain(q, kp, vp, table, keys, starts)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all() and torch.equal(got, again)
        err = (got.float() - ref.float()).abs().max().item()
        assert err / max(1.0, ref.float().abs().max().item()) <= tol, (err, starts)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tol", [("float32", 1e-4), ("bfloat16", 3e-2), ("int8", 3e-2)])
def test_paged_write_attend_matches_plain_on_the_card(cuda_device, kind, tol):
    """Write-and-attend in one launch against its plain version (the two plain
    writes, then the plain attention over ``positions + 1`` keys) at ragged
    shapes and at the edges of the split plan: the new key at position 0, on a
    page boundary, at the last key of a run and on a run boundary, under a
    window and a softcap, a dead slot (its table row zeroed), slots past the
    table and below 0 (trash page 0, key not scored), new rows in the other
    float dtype. Pools bit for bit outside trash page 0; live rows within
    ``tol`` of max(1, max |plain|) and the same bits on a second run from the
    same pools; one launch per call and no launch of the other paged kernels."""
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    counter = "paged_attention_write" + ("_q8" if kind == "int8" else "")
    before = dict(launch_counts)

    def clone(p):
        return {k: v.clone() for k, v in p.items()} if isinstance(p, dict) else p.clone()

    def leaves(p, lead):
        """The pool's tensors with trash page 0 cut out."""
        cut = (slice(None),) * (lead + 1) + (slice(1, None),)
        return [t[cut] for t in (p.values() if isinstance(p, dict) else [p])]

    # b, nq, nkv, hd, ps, mp, layers, softcap, window, positions (None: random), new dtype
    run = tpa.split_plan(8, 8, 8, 64, 16, 32, tpa._sm_count(cuda_device)).pages_per_split * 16
    assert tpa.split_plan(8, 8, 8, 64, 16, 32, tpa._sm_count(cuda_device)).splits > 2
    cases = [
        (3, 4, 4, 64, 16, 4, None, None, None, None, dtype),
        (2, 6, 2, 40, 12, 5, 3, 30.0, 17, None, dtype),
        (4, 8, 1, 128, 8, 6, 2, None, None, None, other),
        (1, 4, 2, 256, 5, 7, None, 50.0, 9, None, dtype),
        (5, 2, 2, 20, 3, 9, None, None, 1, None, dtype),
        (2, 32, 8, 80, 64, 2, 2, None, 100, None, other),
        # the split plan's edges at a 32-page table: 0, a page boundary, a run's last key,
        # a run boundary and the one after, the table's last slot, past the table, below 0
        (8, 8, 8, 64, 16, 32, None, None, None,
         [0, 16, run - 1, run, run + 1, 32 * 16 - 1, 32 * 16 + 3, -1], dtype),
        (8, 8, 8, 64, 16, 32, 2, 20.0, run // 2,
         [0, 15, run - 1, run, 2 * run, 2 * run + 7, 32 * 16 - 1, 5], dtype),
    ]
    for b, nq, nkv, hd, ps, mp, layers, softcap, window, positions, new_dtype in cases:
        lead = () if layers is None else (layers,)
        layer = None if layers is None else layers - 1
        P = 1 + b * mp
        shape = lead + (nkv, P, ps, hd)

        def pool():
            vals = torch.randn(shape, generator=gen, device=cuda_device)
            if kind == "int8":
                codes, sc = tpa.quantize_token_kv(vals)
                return {"q": codes, "s": sc}
            return vals.to(dtype)

        kp, vp = pool(), pool()
        table = (1 + torch.randperm(P - 1, generator=gen, device=cuda_device)[: b * mp]
                 ).reshape(b, mp).to(torch.int32)
        if positions is None:
            pos = torch.randint(0, mp * ps, (b,), generator=gen, device=cuda_device)
            pos[0] = 0
        else:
            pos = torch.tensor(positions, device=cuda_device)
        pos = pos.to(torch.int32)
        live = pos >= 0  # past the table: its mp * ps keys, the written key not among them
        if positions is not None and layers is not None:
            table[-1] = 0  # a dead slot: its table row zeroed, it writes and reads page 0
            live[-1] = False
        starts = None if window is None else (pos + 1 - window).clamp_min(0).to(torch.int32)
        q = torch.randn(b, nq, hd, generator=gen, device=cuda_device).to(dtype)
        k_new = torch.randn(b, nkv, hd, generator=gen, device=cuda_device).to(new_dtype)
        v_new = torch.randn(b, nkv, hd, generator=gen, device=cuda_device).to(new_dtype)
        k_new[0, 0] = 0  # a zero row: scale 1, codes 0
        runs = []
        for _ in range(2):
            k2, v2 = clone(kp), clone(vp)
            runs.append((tpa.paged_attention_write(q, k_new, v_new, k2, v2, table, pos, starts,
                                                   softcap, layer), k2, v2))
        ref = tpa.paged_attention_write_plain(q, k_new, v_new, kp, vp, table, pos, starts,
                                              softcap, layer)
        torch.cuda.synchronize()
        (got, k1, v1), (again, k2, v2) = runs
        assert torch.equal(got[live], again[live])  # a dead slot reads what it writes
        for a, b_, r in ((k1, k2, kp), (v1, v2, vp)):
            for x, y, z in zip(leaves(a, len(lead)), leaves(b_, len(lead)), leaves(r, len(lead))):
                assert torch.equal(x, y) and torch.equal(x, z)
        got, ref = got[live].float(), ref[live].float()
        assert torch.isfinite(got).all()
        err = (got - ref).abs().max().item()
        assert err / max(1.0, ref.abs().max().item()) <= tol, (err, hd, ps, positions)
    assert launch_counts[counter] - before[counter] == 2 * len(cases)
    for name in ("paged_attention", "paged_pool_write"):
        for n in (name, name + "_q8"):
            assert launch_counts[n] == before[n], n


@pytest.mark.cuda
def test_paged_server_on_the_card_matches_the_cpu_backend(cuda_device):
    """A tiny model served with fp32 pools on the card (kernels) and on the
    CPU (plain versions), with a sliding window and the prefix cache: the same
    greedy tokens (weights N(0, 0.02): fp32 differences are ~1e-6)."""
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params
    from ssp_x_vit_tpu_torch.llm.paged import PagedServer
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    cfg = LlamaConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                      intermediate_size=96, sliding_window=9)
    host = init_llama_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = {k: ({kk: vv.to(cuda_device) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(cuda_device)) for k, v in host.items()}
    prompts = [[5, 6, 7, 8, 9, 10, 11], [3], list(range(20, 45))]
    before = dict(launch_counts)
    outs = []
    for params in (host, card):
        srv = PagedServer(params, cfg, max_batch=2, num_pages=40, page_size=4, max_context=64,
                          cache_dtype=torch.float32, prefix_cache=True)
        ids = [srv.add_request(p, max_new_tokens=12) for p in prompts[:2]]
        srv.step_many(5)
        srv.run(1)
        ids.append(srv.add_request(prompts[2], max_new_tokens=12))
        done = srv.run(8)
        outs.append([done[i].tolist() for i in ids])
    assert outs[0] == outs[1]
    # each decode layer makes one write-and-attend launch and nothing else of the paged kernels
    assert launch_counts["paged_attention_write"] > before["paged_attention_write"]
    for name in ("paged_attention", "paged_pool_write"):
        assert launch_counts[name] == before[name], name


@pytest.mark.cuda
def test_w8a8_matmul_on_the_card_matches_the_cpu(cuda_device):
    """The int8 x int8 product (``torch._int_mm`` on the card, rows padded
    past 16 and K, N to multiples of 8 there; an int32 matmul for CPU
    tensors) gives the same integers, so the
    outputs differ by fp32 rounding of the scales only."""
    from ssp_x_vit_tpu_torch.ops.common import w8a8_matmul

    gen = torch.Generator().manual_seed(0)
    # (256, 136) is what _int_mm takes as it is; (682, 250) is a pruned down
    # projection's shape, K and N both off a multiple of 8 (padded on the card).
    for k, n in ((256, 136), (682, 250)):
        w_q = torch.randint(-127, 128, (k, n), generator=gen).to(torch.int8)
        scale = torch.rand(n, generator=gen) * 0.01 + 0.001
        for rows in ((3,), (2, 40)):
            x = torch.randn(*rows, k, generator=gen)
            ref = w8a8_matmul(x, w_q, scale, torch.float32)
            got = w8a8_matmul(x.to(cuda_device), w_q.to(cuda_device), scale.to(cuda_device),
                              torch.float32)
            assert got.is_cuda and got.shape == ref.shape
            assert (got.cpu() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tiny-random", "tiny-random-phi", "tiny-random-opt",
                                   "tiny-random-gemma", "tiny-random-gemma2", "tiny-random-qwen3"])
def test_llm_cli_on_the_card_matches_the_cpu_backend(cuda_device, model):
    """Every family through the CLI on the card (flash kernel at head_dim 16,
    gemma-2's windows and softcap, phi's partial rotary; then the int4 GEMM)
    against the same run on the CPU backend: the same weights, perplexities
    within rtol 2e-2 at the bf16 default, flash launches in every phase."""
    from ssp_x_vit_tpu_torch.cli import main_llm

    def run(backend, *flags, params=None):
        args = main_llm.build_argparser().parse_args(
            ["--model", model, "--backend", backend, "--synthetic-data", "--seq-len", "128",
             "--num-calibration", "4", "--num-calibration-2ssp", "2", "--logging", "WARNING",
             "--evaluate_perplexity", *flags])
        return main_llm.run(args, model=params)

    host = main_llm.load_model(main_llm.build_argparser().parse_args(["--model", model]),
                               torch.device("cpu"))
    card = ({k: ({kk: vv.to(cuda_device) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(cuda_device)) for k, v in host[0].items()}, host[1])
    prune = ("--dense", "--pruning_method", "blockpruner", "--sparsity_rate", "0.34",
             "--evaluate_inference")
    ref, got = run("cpu", *prune, params=host), run("cuda", *prune, params=card)
    assert got["dense"]["ppl"] == pytest.approx(ref["dense"]["ppl"], rel=2e-2)
    assert got["runs"][0]["inference_ms"] > 0.0
    for phase in ("search", "evaluation"):
        assert got["kernel_launches"][phase]["flash_attention"] > 0
    for quantize, kernel in (("int4", "quant4_matmul"), ("int8", None)):
        ref = run("cpu", "--dense", "--quantize", quantize, "--w8a8", params=host)
        got = run("cuda", "--dense", "--quantize", quantize, "--w8a8", params=card)
        assert got["dense"]["ppl"] == pytest.approx(ref["dense"]["ppl"], rel=2e-2)
        if kernel:
            assert got["kernel_launches"]["evaluation"][kernel] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tiny-random", "tiny-random-gemma2"])
def test_train_cli_on_the_card_matches_the_cpu_backend(cuda_device, model, tmp_path):
    """The training CLI on the card (forward with lse, dq and dk/dv kernels,
    remat; gemma-2's windows and softcap) against the CPU backend: the same
    tiny model (made on the CPU, saved, loaded by both as bf16) and batches,
    fp32 compute, losses within 1e-4 relative; the flash forward runs twice
    per layer and update (remat), each backward kernel once."""
    from ssp_x_vit_tpu_torch.cli import main_llm, train_llm
    from ssp_x_vit_tpu_torch.llm.checkpoints import save_llm_model
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    save_llm_model(str(tmp_path), *main_llm.load_model(
        main_llm.build_argparser().parse_args(["--model", model]), torch.device("cpu")))

    def run(backend):
        return train_llm.run(train_llm.build_argparser().parse_args(
            ["--model", str(tmp_path), "--backend", backend, "--steps", "3", "--batch-size",
             "2", "--seq-len", "96", "--compute-dtype", "float32", "--log-every", "1",
             "--lr", "1e-3", "--synthetic-data"]))

    ref = run("cpu")
    reset_launch_counts()
    got = run("cuda")
    for a, b in zip(got["history"], ref["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    layers = got["cfg"].num_layers
    assert launch_counts["flash_attention"] == 2 * 3 * layers
    assert launch_counts["flash_attention_bwd_dq"] == launch_counts["flash_attention_bwd_dkv"] \
        == 3 * layers


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_fused_ffn_block_gradients_on_the_card_match_the_cpu(cuda_device, dtype, tol):
    """Under autograd the FFN block kernel runs inside its autograd Function:
    the output has a grad_fn, and the gradients of every input (the gate a
    tensor) match the CPU's within tol of max(1, max |cpu|); the attention
    block kernels raise under autograd."""
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffk
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    gen = torch.Generator().manual_seed(1)
    b, s, d, f = 2, 65, 96, 384
    host = [torch.randn(b, s, d, generator=gen), 1 + 0.1 * torch.randn(d, generator=gen),
            0.1 * torch.randn(d, generator=gen), torch.randn(d, f, generator=gen) * d ** -0.5,
            0.1 * torch.randn(f, generator=gen), torch.randn(f, d, generator=gen) * f ** -0.5,
            0.1 * torch.randn(d, generator=gen), torch.full((), 0.7)]
    mask = (torch.rand(f, generator=gen) > 0.3).float()
    g_out = torch.randn(b, s, d, generator=gen)

    def grads(device, compute_dtype):
        leaves = [t.to(device=device, dtype=compute_dtype if t.dim() else torch.float32,
                       copy=True).requires_grad_() for t in host]
        out, stats = ffk.fused_ffn_block(*leaves[:7], neuron_mask=mask.to(device), gate=leaves[7],
                                         collect_stats=True)
        assert out.grad_fn is not None and stats.grad_fn is None
        out.backward(g_out.to(device=device, dtype=compute_dtype))
        return [t.grad.float().cpu() for t in leaves]

    before = launch_counts["fused_ffn_block"]
    got = grads(cuda_device, dtype)
    assert launch_counts["fused_ffn_block"] - before == 1
    for a, r in zip(got, grads("cpu", torch.float32)):
        err = (a - r).abs().max().item()
        assert err / max(1.0, r.abs().max().item()) <= tol, err
    x = host[0].to(cuda_device, dtype).requires_grad_()
    attn = [t.to(cuda_device, dtype) for t in (torch.ones(d), torch.zeros(d),
                                               torch.randn(d, 3 * d) * 0.05, torch.zeros(3 * d),
                                               torch.randn(d, d) * 0.05, torch.zeros(d))]
    for name, heads in (("fused_attn_block_v2", 4), ("fused_attn_block", 3)):
        with pytest.raises(RuntimeError, match="allow_fused_attn=False"):
            getattr(fab, name)(x, *attn, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_dequant_gemm_tiles_at_their_edge_shapes_on_the_card(cuda_device, dtype, tol):
    """quant_matmul, quant4_matmul and fused_mlp_int8 against their plain
    versions where the tile pipeline changes course: activation rows 1, 8,
    17, 64, 136, 300 (tiles of 16-128 rows, split-K), K = 682 and 8190 and
    N = 250 (element loads instead of TMA), an x whose base is one element
    off 16 bytes; the same bits on a second run."""
    from ssp_x_vit_tpu_torch.llm.quant import quantize_weight_int8
    from ssp_x_vit_tpu_torch.ops.kernels import quant_fused_mlp as tfm
    from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def check(fn, plain, *args):
        got, again, ref = fn(*args), fn(*args), plain(*args)
        assert torch.isfinite(got.float()).all() and torch.equal(got, again)
        err, peak = (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
        assert peak >= 1.0, peak  # the limit follows the output's own peak
        assert err / peak <= tol, err

    def rows(m, k, offset=False):
        x = torch.randn(m * k + offset, generator=gen, device=cuda_device).to(dtype)
        return x[offset:].view(m, k)

    for m, k, n in ((1, 1024, 512), (8, 4096, 768), (17, 682, 512), (64, 8190, 256),
                    (136, 1024, 250), (300, 2048, 1024)):
        w4 = torch.randint(-128, 128, (k // 2, n), generator=gen, device=cuda_device).to(torch.int8)
        w8 = torch.randint(-127, 128, (k, n), generator=gen, device=cuda_device).to(torch.int8)
        sc = torch.rand(n, generator=gen, device=cuda_device) * 0.01 + 0.001
        for offset in (False, True):
            x = rows(m, k, offset)
            check(tqm.quant_matmul, tqm.quant_matmul_plain, x, w8, sc)
            check(tqm.quant4_matmul, tqm.quant4_matmul_plain, x, w4, sc)
    for m, d, f in ((17, 512, 1024), (64, 682, 250), (136, 1024, 1030), (300, 768, 2048)):
        ws = [quantize_weight_int8(torch.randn(*shape, generator=gen, device=cuda_device)
                                   * shape[0] ** -0.5)  # N(0, 1/fan_in): max |plain| >= 1
              for shape in ((d, f), (d, f), (f, d))]
        args = [t for pair in ws for t in pair]
        for offset in (False, True):
            check(tfm.fused_mlp_int8, tfm.fused_mlp_int8_plain, rows(m, d, offset), *args)
