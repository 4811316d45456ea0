#!/usr/bin/env python3
"""``chip_smoke.py``'s ahead-of-time artifacts phase (``[AOT]``, ``llm/aot.py``).

    python3 scripts/torch_aot_phase.py   # the phase alone on one card

The phase exports, with ``torch.export`` from CUDA tensors, the ViT classify
forward of ViT-B/16 (published widths and depth, random weights, bf16, b=64;
the dense tree and a 2SSP-materialized one: every FFN cut by 25% and the
attention of blocks 3 and 8 removed) and of ViT-Ti/16 (3 heads), and the
serving bundle (prefill at the 512 bucket + decode step, b=8, bf16 cache of
640 slots) of the ``[GEN]`` int8 tree (Llama-2-7B widths, the first
``CONTIGUOUS_LAYERS`` layers) and, cut to 2 layers, of an int4 tree. It saves
the artifacts and the parameters (``torch.save``), then a fresh process
(``--child WORK``) loads them without importing the model code, runs the ViT
artifacts on the phase's pixels and drives 32 greedy tokens of the 8 prompts
(64-512 tokens) through the LLM artifacts alone, counting the launches while
the artifacts run; a second fresh process (``--live WORK``) makes the live
path's first calls, the cold start the artifacts are compared with. The int4
bundle is driven in the phase's own process (prefill + 8 decode steps).

Checks (any failure raises): each graph holds the expected ``ssp`` operator
nodes (rows 1 / 3: 12 each for dense B/16, 10 / 12 for the pruned tree; row
2: 12 for Ti/16; row 11: 16 a program; row 10: 7 x 2 a program); exporting
launches nothing; the ViT logits equal the live forward's bit for bit, or lie
within 5e-2 of max(1, max |logit|) with the difference logged; the LLM tokens
equal the live path's (``prefill`` and ``decode_scan``, the loop
``generate_kv_scan`` runs, on the same tree, prompts and cache shape) token
for token; the artifacts' launches are rows 1 / 3 = 12 a dense B/16 call,
row 11 = 16 x 32 for the int8 drive, row 10 = 7 x 2 x 9 for the int4 drive;
the fresh process imported none of ``llm.serve``, ``llm.model``,
``models.vit``. Recorded: export seconds, artifact bytes, load seconds in the
fresh process, its first calls against the live path's first calls in the
other fresh process, ms per forward and per decode step through the artifact
against the live path.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VIT_BATCH = 64
LLM_BATCH, LLM_BUCKET, LLM_MAX_LEN, LLM_TOKENS = 8, 512, 640, 32
INT4_LAYERS, INT4_STEPS = 2, 8
PRUNED_BLOCKS = (3, 8)          # attention removed in the 2SSP-materialized B/16 tree
CHILD_TIMEOUT_S = 300
MODEL_MODULES = ("ssp_x_vit_tpu_torch.llm.serve", "ssp_x_vit_tpu_torch.llm.model",
                 "ssp_x_vit_tpu_torch.models.vit")


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts() -> dict:
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    return {k: v for k, v in launch_counts.items() if v}


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


# ------------------------------------------------------------- the models ---

def _vit_models(device):
    """{name: (params, cfg)}: ViT-B/16 dense and 2SSP-materialized, ViT-Ti/16;
    random weights from seeds, bf16."""
    import torch

    from ssp_x_vit_tpu_torch.cli.common import NAMED_CONFIGS
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig, cast_params, init_vit_params
    from ssp_x_vit_tpu_torch.pruning import (
        materialize_depth_pruning, materialize_width_pruning, select_keep_indices,
        weight_l1_importance,
    )

    out = {}
    for name, seed in (("vit_b16", 0), ("vit_ti16", 1)):
        cfg = ViTConfig(**dict(NAMED_CONFIGS[name.replace("_", "-")], num_classes=1000))
        out[name] = (cast_params(init_vit_params(cfg, seed=seed, device=device), torch.bfloat16), cfg)
    params, cfg = out["vit_b16"]
    f = cfg.intermediate_size
    keep = select_keep_indices(weight_l1_importance(params),
                               n_to_prune_per_block=[f // 4] * cfg.num_layers,
                               min_remaining=1, verbose=False).keep_indices
    pruned, pcfg = materialize_depth_pruning(*materialize_width_pruning(params, cfg, keep),
                                             list(PRUNED_BLOCKS))
    out["vit_b16_pruned"] = (cast_params(pruned, torch.bfloat16), pcfg)
    return out


def _vit_live(params, cfg, pixels):
    import torch

    from ssp_x_vit_tpu_torch.models.vit import vit_forward, vit_forward_materialized

    with torch.no_grad():
        if cfg.pruned_attention_blocks:
            return vit_forward_materialized(params, pixels, cfg, compute_dtype=pixels.dtype)
        return vit_forward(params, pixels, cfg, compute_dtype=pixels.dtype)[0]


def _prompts(cfg):
    """The ``[GEN]`` prompts (b=8 of 64-512 tokens), left-padded to the
    bucket: (tokens int64 [8, bucket], pad_lens int64 [8]) as numpy arrays."""
    import numpy as np

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.serve import _prepare_prompts

    lo, hi = 64, 512
    rng = np.random.default_rng(31)
    lens = [lo, hi] + sorted(rng.integers(lo + 1, hi, LLM_BATCH - 2).tolist())
    stream = synthetic_token_stream(sum(lens), cfg.vocab_size, seed=33).reshape(-1)
    cuts = np.cumsum([0] + lens)
    prompts = [stream[cuts[i]:cuts[i + 1]].astype(np.int64) for i in range(len(lens))]
    tokens, pad_lens, _, p_pad = _prepare_prompts(prompts, LLM_MAX_LEN)
    assert p_pad == LLM_BUCKET, p_pad
    return tokens.astype(np.int64), pad_lens.astype(np.int64)


def _live_tokens(params, cfg, toks, pads, steps):
    """The live path's greedy tokens [b, 1 + steps]: ``prefill`` then
    ``decode_scan`` (the loop ``generate_kv_scan`` runs) on a bf16 cache of
    ``LLM_MAX_LEN`` slots, the artifacts' shapes."""
    import torch

    from ssp_x_vit_tpu_torch.llm import serve

    ck, cv = serve.init_cache(cfg, toks.shape[0], LLM_MAX_LEN, torch.bfloat16, toks.device)
    logits, ck, cv = serve.prefill(params, toks, ck, cv, cfg, pads)
    first = logits.argmax(-1)
    rest, _, _ = serve.decode_scan(params, first, ck, cv, cfg, toks.shape[1], pads, steps)
    return torch.cat([first[:, None], rest.t()], dim=1)


def _drive(artifacts, params, toks, pads, cache_shape, steps):
    """Greedy tokens [b, 1 + steps] through the artifacts alone (the position
    a 0-d tensor on the device, the tokens fed back on the device), and
    ``more(n)``, which runs n more decode steps from where the drive ended."""
    import torch

    device = toks.device
    ck = torch.zeros(cache_shape, dtype=torch.bfloat16, device=device)
    cv = torch.zeros(cache_shape, dtype=torch.bfloat16, device=device)
    dec = artifacts["decode"]
    logits, ck, cv = artifacts[f"prefill_{toks.shape[1]}"].call(params, toks, ck, cv, pads)
    out = [logits.argmax(-1)]
    pos = torch.tensor(toks.shape[1], dtype=torch.int64, device=device)

    def more(n):
        nonlocal pos
        for _ in range(n):
            lg, _, _ = dec.call(params, out[-1], ck, cv, pos, pads)
            out.append(lg.argmax(-1))
            pos = pos + 1

    more(steps)
    return torch.stack(out, dim=1), more


# ------------------------------------------------------------- the phase ---

def phase_aot(device, llama_params, llama_cfg) -> dict:
    """The ``[AOT]`` phase (module docstring); ``llama_params`` / ``llama_cfg``:
    the bf16 Llama-2-7B-width tree cut to ``CONTIGUOUS_LAYERS`` layers. Returns
    the launches made while the artifacts ran, per kernel (the fresh process's
    and the int4 drive's)."""
    import torch

    from ssp_x_vit_tpu_torch.llm import aot
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int4, quantize_llm_params_int8
    from ssp_x_vit_tpu_torch.ops.kernels import reset_launch_counts

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        # --- models, inputs, exports (no launch may happen while exporting)
        vits = _vit_models(device)
        cfg0 = vits["vit_b16"][1]
        gen = torch.Generator(device=device).manual_seed(7)
        pixels = {}
        for name, (params, cfg) in vits.items():
            pixels[name] = torch.randn((VIT_BATCH, cfg.image_size, cfg.image_size, 3),
                                       generator=gen, device=device).to(torch.bfloat16)
        q8 = quantize_llm_params_int8(llama_params, llama_cfg)
        cut = {k: v for k, v in llama_params.items() if k != "blocks"}
        cut["blocks"] = {k: v[:INT4_LAYERS] for k, v in llama_params["blocks"].items()}
        cfg4 = dataclasses.replace(llama_cfg, num_layers=INT4_LAYERS)
        q4 = quantize_llm_params_int4(cut, cfg4)
        toks_np, pads_np = _prompts(llama_cfg)
        toks = torch.from_numpy(toks_np).to(device)
        pads = torch.from_numpy(pads_np).to(device)
        # --- what the fresh processes read besides the artifacts: parameters, inputs
        t0 = time.perf_counter()
        for name in vits:
            torch.save(vits[name][0], os.path.join(work, name + "_params.pt"))
            torch.save(pixels[name], os.path.join(work, name + "_pixels.pt"))
        t_vit = time.perf_counter() - t0
        _, t_llm = _timed(lambda: torch.save(q8, os.path.join(work, "llm_int8_params.pt")),
                          device)
        llm_bytes = os.path.getsize(os.path.join(work, "llm_int8_params.pt"))
        cache_shape = (llama_cfg.num_layers, LLM_BATCH, LLM_MAX_LEN,
                       llama_cfg.num_kv_heads, llama_cfg.head_dim)
        torch.save(dict(tokens=toks.cpu(), pads=pads.cpu(), cache_shape=cache_shape,
                        steps=LLM_TOKENS - 1, device=str(device),
                        vit_b16_cfg=dataclasses.asdict(cfg0),
                        llama_cfg=dataclasses.asdict(llama_cfg)),
                   os.path.join(work, "inputs.pt"))
        log(f"[AOT] parameters written with torch.save for the fresh processes: the ViT trees "
            f"and pixels {t_vit:.2f} s, the int8 tree ({llm_bytes / 2 ** 30:.2f} GiB) "
            f"{t_llm:.2f} s")

        # --- the live path's fresh process runs while this one exports: an export
        # is one host thread and touches no device memory (fake tensors)
        live_proc = _start_child("--live", work)
        try:
            _sync(device)
            reset_launch_counts()
            exports, blobs = {}, {}
            for name, (params, cfg) in vits.items():
                blobs[name], exports[name] = _timed(lambda: aot.export_vit_classify(
                    params, cfg, batch=VIT_BATCH, compute_dtype=torch.bfloat16), device)
            bundles = {}
            for name, tree, cfg in (("llm_int8", q8, llama_cfg), ("llm_int4", q4, cfg4)):
                bundles[name], exports[name] = _timed(lambda: aot.export_serving_bundle(
                    tree, cfg, batch=LLM_BATCH, prompt_buckets=[LLM_BUCKET],
                    max_len=LLM_MAX_LEN, cache_dtype=torch.bfloat16), device)
        finally:
            live = _finish_child(live_proc, work)
        if _counts():
            raise AssertionError(f"[AOT] exporting launched kernels: {_counts()}")
        nbytes = {name: len(b) for name, b in blobs.items()}
        nbytes.update({f"{name}/{k}": len(b) for name, bundle in bundles.items()
                       for k, b in bundle.items()})
        log(f"[AOT] exported from {device.type} tensors in seconds {json.dumps(exports)}; "
            f"artifact bytes {json.dumps(nbytes)}; no launch while exporting")
        for name, blob in blobs.items():
            with open(os.path.join(work, name + aot.SUFFIX), "wb") as f:
                f.write(blob)
        aot.save_bundle(bundles["llm_int8"], os.path.join(work, "llm_int8"))

        # --- the live references, and ms per call of artifact and live path, in this process
        live_logits = {name: _vit_live(params, cfg, pixels[name])
                       for name, (params, cfg) in vits.items()}
        live8 = _live_tokens(q8, llama_cfg, toks, pads, LLM_TOKENS - 1)
        live4 = _live_tokens(q4, cfg4, toks, pads, INT4_STEPS)
        ms = {}
        for name, (params, cfg) in vits.items():
            art = aot.load_artifact(blobs[name])
            ms[name] = _in_turns(lambda: _vit_live(params, cfg, pixels[name]),
                                 lambda: art.call(params, pixels[name]), device, 5)
        arts8 = {k: aot.load_artifact(b) for k, b in bundles["llm_int8"].items()}
        _, more_art = _drive(arts8, q8, toks, pads, cache_shape, 0)
        more_live = _live_decoder(q8, llama_cfg, toks, pads)
        ms["llm_int8 decode step"] = _in_turns(lambda: more_live(1), lambda: more_art(1),
                                               device, 16)
        del arts8, more_art, more_live

        # --- the int4 bundle, driven here from its bytes
        arts4 = {k: aot.load_artifact(b) for k, b in bundles["llm_int4"].items()}
        _sync(device)
        reset_launch_counts()
        got4, _ = _drive(arts4, q4, toks, pads, (INT4_LAYERS, *cache_shape[1:]),
                         INT4_STEPS)
        _sync(device)
        launches4 = _counts()

        # --- the artifacts' fresh process
        child = _finish_child(_start_child("--child", work), work)
        outs = torch.load(os.path.join(work, "child_outputs.pt"), map_location=device)

    # --- checks
    failures = []
    want_nodes = {"vit_b16": {"fused_attn_block_v2": 12, "fused_ffn_block": 12},
                  "vit_b16_pruned": {"fused_attn_block_v2": 12 - len(PRUNED_BLOCKS),
                                     "fused_ffn_block": 12},
                  "vit_ti16": {"fused_attn_block": 12, "fused_ffn_block": 12},
                  "llm_int8/prefill_%d" % LLM_BUCKET: {"fused_mlp_int8": llama_cfg.num_layers},
                  "llm_int8/decode": {"fused_mlp_int8": llama_cfg.num_layers}}
    nodes = dict(child["nodes"])
    nodes.update({f"llm_int4/{k}": a.operator_counts() for k, a in arts4.items()})
    want_nodes.update({f"llm_int4/{k}": {"quant4_matmul": 7 * INT4_LAYERS} for k in arts4})
    for name, want in want_nodes.items():
        if nodes[name] != want:
            failures.append(f"{name}: graph nodes {nodes[name]}, expected {want}")
    vit_err = {}
    for name in vits:
        got, ref = outs[name].float(), live_logits[name].float()
        err = (got - ref).abs().max().item()
        vit_err[name] = dict(max_abs=err, bits_equal=bool(torch.equal(outs[name],
                                                                       live_logits[name])),
                             scaled=err / max(1.0, ref.abs().max().item()))
        if vit_err[name]["scaled"] > 5e-2:
            failures.append(f"{name}: logits {err} from the live forward's")
    tokens8 = outs["llm_int8_tokens"]
    same8 = bool(torch.equal(tokens8, live8))
    same4 = bool(torch.equal(got4, live4))
    if not (same8 and same4):
        failures.append(f"tokens differ from the live path (int8 {same8}, int4 {same4})")
    n8 = llama_cfg.num_layers * LLM_TOKENS
    n4 = 7 * INT4_LAYERS * (1 + INT4_STEPS)
    want_launches = {"vit_b16": {"fused_attn_block_v2": 12, "fused_ffn_block": 12},
                     "vit_b16_pruned": {"fused_attn_block_v2": 12 - len(PRUNED_BLOCKS),
                                        "fused_ffn_block": 12},
                     "vit_ti16": {"fused_attn_block": 12, "fused_ffn_block": 12},
                     "llm_int8": {"fused_mlp_int8": n8}, "llm_int4": {"quant4_matmul": n4}}
    got_launches = dict(child["launches"], llm_int4=launches4)
    for name, want in want_launches.items():
        if got_launches[name] != want:
            failures.append(f"{name}: launches {got_launches[name]}, expected {want}")
    if child["model_modules"]:
        failures.append(f"the fresh process imported model code: {child['model_modules']}")
    log(f"[AOT] fresh process (artifacts only): started and imported in "
        f"{child['startup_s']:.2f} s; deserialize seconds {json.dumps(child['deserialize_s'])}; "
        f"parameter load seconds {json.dumps(child['load_s'])}; first call seconds "
        f"{json.dumps(child['first_s'])}; second call {json.dumps(child['second_s'])}; "
        f"graph nodes {json.dumps(nodes)}; launches "
        f"while the artifacts ran {json.dumps(got_launches)}; model modules imported "
        f"{child['model_modules']}")
    cold = {k: round(child["deserialize_s"][k] + child["first_s"][k], 3)
            for k in live["first_s"]}
    log(f"[AOT] fresh process (live path): started and imported the model code in "
        f"{live['startup_s']:.2f} s; parameter load seconds {json.dumps(live['load_s'])}; "
        f"first call seconds {json.dumps(live['first_s'])}; second call "
        f"{json.dumps(live['second_s'])} (artifacts: deserialize + first call "
        f"{json.dumps(cold)})")
    log(f"[AOT] ViT logits, artifact in the fresh process against the live forward here: "
        f"{json.dumps(vit_err)} (rule: equal bits expected, 5e-2 of max(1, max |logit|))")
    log(f"[AOT] ms per call in this process, in turns (live, artifact, artifact, live; host "
        f"clock around synchronized calls; b={VIT_BATCH} ViT forwards, b={LLM_BATCH} decode "
        f"steps): {json.dumps(ms)}")
    log(f"[AOT] int8 tree, {llama_cfg.num_layers} layers, b={LLM_BATCH}, prompts at the "
        f"{LLM_BUCKET} bucket, {LLM_MAX_LEN}-slot bf16 cache: {LLM_TOKENS} "
        f"greedy tokens through the artifacts alone == the live path's: {same8}; int4 tree, "
        f"{INT4_LAYERS} layers, prefill + {INT4_STEPS} decode steps: {same4}")
    log(f"[AOT] phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("[AOT] " + "; ".join(failures))
    launches = {}
    for counts in got_launches.values():
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return launches


def _live_decoder(params, cfg, toks, pads):
    """The live path after its prefill, as ``_drive`` leaves the artifacts:
    ``more(n)`` runs n ``decode_step`` calls (the layers split once, as
    ``decode_scan`` does), the tokens fed back on the device."""
    import torch

    from ssp_x_vit_tpu_torch.llm import serve

    layers = serve.split_layers(params, cfg)
    ck, cv = serve.init_cache(cfg, toks.shape[0], LLM_MAX_LEN, torch.bfloat16, toks.device)
    logits, ck, cv = serve.prefill(params, toks, ck, cv, cfg, pads, layers=layers)
    tok, pos = logits.argmax(-1), toks.shape[1]

    def more(n):
        nonlocal tok, pos
        with torch.no_grad():
            for _ in range(n):
                lg, _, _ = serve.decode_step(params, tok, ck, cv, cfg, pos, pads, layers=layers)
                tok, pos = lg.argmax(-1), pos + 1

    return more


def _in_turns(live, artifact, device, iters: int) -> dict:
    """ms per call of each, host clock around ``iters`` synchronized calls, in
    turns live, artifact, artifact, live after one warm call of each."""
    live(), artifact()
    out = {"live": [], "artifact": []}
    for name, fn in (("live", live), ("artifact", artifact), ("artifact", artifact),
                     ("live", live)):
        _, seconds = _timed(lambda: [fn() for _ in range(iters)], device)
        out[name].append(round(seconds * 1e3 / iters, 4))
    return out


def _start_child(flag: str, work: str):
    """This script as a fresh process (``--child`` / ``--live``) on ``work``;
    its output goes to ``work/<flag>.log``."""
    out = open(os.path.join(work, flag.strip("-") + ".log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, work], cwd=ROOT,
                            stdout=out, stderr=subprocess.STDOUT)
    out.close()
    return flag, proc, time.perf_counter()


def _finish_child(started, work: str) -> dict:
    """Wait for a ``_start_child`` process (killed past ``CHILD_TIMEOUT_S``)
    and read the JSON it wrote; raise with its log if it failed."""
    flag, proc, t0 = started
    name = flag.strip("-")
    try:
        rc = proc.wait(timeout=max(1.0, CHILD_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed after %d s" % CHILD_TIMEOUT_S
    if rc != 0:
        with open(os.path.join(work, name + ".log")) as f:
            raise AssertionError(f"[AOT] {flag} process: exit {rc}\n{f.read()[-6000:]}")
    with open(os.path.join(work, name + ".json")) as f:
        out = json.load(f)
    out["wall_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------ the fresh processes ---

def child_main(work: str) -> int:
    """Load every artifact and parameter file of ``work`` and run them, with
    no model module imported; write ``child.json`` and ``child_outputs.pt``."""
    t_start = time.perf_counter()
    import torch

    from ssp_x_vit_tpu_torch.llm import aot
    from ssp_x_vit_tpu_torch.ops.kernels import reset_launch_counts

    inputs = torch.load(os.path.join(work, "inputs.pt"))
    device = torch.device(inputs["device"])
    if device.type == "cuda":
        torch.cuda.init()
    startup = time.perf_counter() - t_start
    out = dict(deserialize_s={}, load_s={}, first_s={}, second_s={}, nodes={}, launches={})
    tensors = {}
    for name in ("vit_b16", "vit_b16_pruned", "vit_ti16"):
        t0 = time.perf_counter()
        with open(os.path.join(work, name + aot.SUFFIX), "rb") as f:
            art = aot.load_artifact(f.read())
        out["deserialize_s"][name] = time.perf_counter() - t0
        params = torch.load(os.path.join(work, name + "_params.pt"), map_location=device)
        pixels = torch.load(os.path.join(work, name + "_pixels.pt"), map_location=device)
        _sync(device)
        out["load_s"][name] = time.perf_counter() - t0 - out["deserialize_s"][name]
        out["nodes"][name] = art.operator_counts()
        reset_launch_counts()
        tensors[name], out["first_s"][name] = _timed(lambda: art.call(params, pixels), device)
        out["launches"][name] = _counts()
        _, out["second_s"][name] = _timed(lambda: art.call(params, pixels), device)
    t0 = time.perf_counter()
    arts = aot.load_bundle(os.path.join(work, "llm_int8"))
    out["deserialize_s"]["llm_int8"] = time.perf_counter() - t0
    params = torch.load(os.path.join(work, "llm_int8_params.pt"), map_location=device)
    _sync(device)
    out["load_s"]["llm_int8"] = time.perf_counter() - t0 - out["deserialize_s"]["llm_int8"]
    out["nodes"].update({f"llm_int8/{k}": a.operator_counts() for k, a in arts.items()})
    toks, pads = inputs["tokens"].to(device), inputs["pads"].to(device)
    for key in ("first_s", "second_s"):
        _, out[key]["llm_int8"] = _timed(lambda: _drive(
            arts, params, toks, pads, inputs["cache_shape"], 0), device)
    reset_launch_counts()
    tensors["llm_int8_tokens"], _ = _drive(arts, params, toks, pads, inputs["cache_shape"],
                                           inputs["steps"])
    _sync(device)
    out["launches"]["llm_int8"] = _counts()
    out["model_modules"] = sorted(m for m in MODEL_MODULES if m in sys.modules)
    out["startup_s"] = startup
    torch.save({k: v.cpu() for k, v in tensors.items()}, os.path.join(work, "child_outputs.pt"))
    with open(os.path.join(work, "child.json"), "w") as f:
        json.dump(out, f)
    return 0


def live_main(work: str) -> int:
    """The live path's first calls in a fresh process: import the model code,
    load the parameters, one dense ViT-B/16 forward and one LLM prefill."""
    t_start = time.perf_counter()
    import torch

    from ssp_x_vit_tpu_torch.llm import serve
    from ssp_x_vit_tpu_torch.llm.checkpoints import config_from_dict
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig

    inputs = torch.load(os.path.join(work, "inputs.pt"))
    device = torch.device(inputs["device"])
    if device.type == "cuda":
        torch.cuda.init()
    out = dict(startup_s=time.perf_counter() - t_start, load_s={}, first_s={}, second_s={})
    t0 = time.perf_counter()
    params = torch.load(os.path.join(work, "vit_b16_params.pt"), map_location=device)
    pixels = torch.load(os.path.join(work, "vit_b16_pixels.pt"), map_location=device)
    cfg = ViTConfig(**inputs["vit_b16_cfg"])
    _sync(device)
    out["load_s"]["vit_b16"] = time.perf_counter() - t0
    for key in ("first_s", "second_s"):
        _, out[key]["vit_b16"] = _timed(lambda: _vit_live(params, cfg, pixels), device)
    t0 = time.perf_counter()
    params = torch.load(os.path.join(work, "llm_int8_params.pt"), map_location=device)
    cfg = config_from_dict(inputs["llama_cfg"])
    toks, pads = inputs["tokens"].to(device), inputs["pads"].to(device)
    _sync(device)
    out["load_s"]["llm_int8"] = time.perf_counter() - t0

    def first_prefill():
        ck, cv = serve.init_cache(cfg, toks.shape[0], inputs["cache_shape"][2], torch.bfloat16,
                                  device)
        return serve.prefill(params, toks, ck, cv, cfg, pads)

    for key in ("first_s", "second_s"):
        _, out[key]["llm_int8"] = _timed(first_prefill, device)
    with open(os.path.join(work, "live.json"), "w") as f:
        json.dump(out, f)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--live":
        return live_main(sys.argv[2])
    import torch

    if sys.argv[1:]:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.ops.kernels import build

    device = torch.device("cuda", 0)
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    params, cfg = cs._first_layers(*cs.make_llama_7b(device), cs.CONTIGUOUS_LAYERS)
    launches = phase_aot(device, params, cfg)
    cs.log(f"[AOT] launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
