#!/usr/bin/env python3
"""Where a served DeepSeek-V3-width token parts from the same prompt run
alone, on one card.

``chip_smoke.py`` serves 8 prompts through ``ServingEngine`` over
``MLAPagedServer`` (V3 widths cut to 4 layers, random bf16 weights) and holds
every served token within 5e-2 of max(1, max |logit|) of the best logit of
the prompt run alone. This script measures that gap over several prompt
seeds and takes it apart:

* served against alone with the same prefill (whole prompt for bf16 pools,
  chunks of 128 for int8 pools) and, for the int8 run, against alone with a
  whole-prompt prefill;
* a replay of the served decode (the 8 prompts prefilled alone, then decoded
  together at b=8 and fed the served tokens) against the served logits (0
  when the replay is the served computation) and against alone, with the MoE
  layer's expert choices of every step compared between replay and alone;
* the same serving on the all-dense variant (no MoE), the same prompts.

    python3 scripts/torch_mla_served_gap.py [--seeds 31 41 51]

Prints the card's name and power limit and one line per measurement; the
last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_routing(ds, sink):
    """Wrap ``deepseek._deepseek_route`` so that every call appends its chosen
    experts ([T, E] bool, on the host) to ``sink`` while ``sink`` is armed."""
    orig = ds._deepseek_route

    def route(xt, bp, cfg):
        w = orig(xt, bp, cfg)
        if sink["armed"]:
            sink["calls"].append((w > 0).cpu())
        return w

    ds._deepseek_route = route
    return orig


def _replay(params, cfg, device, prompts, served, cache_dtype, chunked, routing):
    """Prefill every prompt alone into one pool, then decode all 8 together
    fed the served tokens (the served batch's shapes). Returns per prompt the
    logits of each step [16, V] and the MoE choices of each decode step."""
    import torch

    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.llm import paged_mla as tpm

    page = cs.MLA_PAGE
    pages = max(-(-(len(p) + 17) // page) for p in prompts)
    b = len(prompts)
    pool = tpm.init_mla_pool(cfg, 1 + b * pages, page, cache_dtype, device)
    tables = (1 + torch.arange(b * pages, dtype=torch.int32, device=device)).reshape(b, pages)
    first = []
    for i, p in enumerate(prompts):
        if chunked:
            logits, _ = tpm.mla_paged_prefill_chunked(params, p, pool, cfg, tables[i],
                                                      chunk_size=chunked)
        else:
            logits, _ = tpm.mla_paged_prefill(params, torch.as_tensor([p], device=device), pool,
                                              cfg, tables[i], len(p))
        first.append(logits)
    steps = [torch.stack(first)]
    toks = torch.as_tensor([s for s in served], dtype=torch.int64, device=device)   # [b, 16]
    n = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    choices = []
    for t in range(toks.shape[1] - 1):
        routing["armed"], routing["calls"] = True, []
        logits, _ = tpm.mla_paged_decode_step(params, toks[:, t], pool, cfg, tables, n + t)
        routing["armed"] = False
        choices.append(routing["calls"][-1] if routing["calls"] else None)
        steps.append(logits)
    return torch.stack(steps, dim=1), choices                 # [b, 16, V]


def _alone(params, cfg, device, prompt, tokens, cache_dtype, chunked, routing):
    """The prompt alone (b=1) with the given prefill, fed the served tokens:
    logits of each step [16, V] and the MoE choices of each decode step."""
    import torch

    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.llm import paged_mla as tpm

    page = cs.MLA_PAGE
    n = len(prompt)
    pages = -(-(n + len(tokens) + 1) // page)
    pool = tpm.init_mla_pool(cfg, 1 + pages, page, cache_dtype, device)
    table = torch.arange(1, 1 + pages, dtype=torch.int32, device=device)
    if chunked:
        logits, _ = tpm.mla_paged_prefill_chunked(params, prompt, pool, cfg, table,
                                                  chunk_size=chunked)
    else:
        logits, _ = tpm.mla_paged_prefill(params, torch.as_tensor([prompt], device=device), pool,
                                          cfg, table, n)
    toks = torch.as_tensor(tokens, dtype=torch.int64, device=device)
    steps, choices = [logits], []
    for t in range(len(tokens) - 1):
        routing["armed"], routing["calls"] = True, []
        lens = torch.full((1,), n + t, dtype=torch.int32, device=device)
        logits = tpm.mla_paged_decode_step(params, toks[t:t + 1], pool, cfg, table[None],
                                           lens)[0][0]
        routing["armed"] = False
        choices.append(routing["calls"][-1][0] if routing["calls"] else None)
        steps.append(logits)
    return torch.stack(steps), choices


def _gaps(logits, tokens):
    """Per step: best logit minus the served token's logit."""
    import torch

    toks = torch.as_tensor(tokens, dtype=torch.int64, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(-1, toks[:, None])[:, 0]


def measure(params, cfg, device, seed, cache_dtype, chunked, label, routing) -> dict:
    import torch

    import chip_smoke as cs

    prompts = cs._mla_prompts(cfg, seed)
    served, steps, _, seconds = cs._mla_served(params, cfg, device, prompts, cache_dtype, chunked)
    rep, rep_choices = _replay(params, cfg, device, prompts, served, cache_dtype, chunked, routing)
    out = dict(label=label, seed=seed, decode_steps=steps, seconds=round(seconds, 3))
    modes = [("same prefill", chunked)] + ([("whole prefill", None)] if chunked else [])
    for mode, ch in modes:
        worst = worst_abs = peak_all = 0.0
        exact = total = flips = flip_gap = steady = 0
        steady_worst = 0.0
        rep_worst = 0.0
        for i, (p, s) in enumerate(zip(prompts, served)):
            alone, choices = _alone(params, cfg, device, p, s, cache_dtype, ch, routing)
            g = _gaps(alone, s)
            peak = float(alone.abs().max())
            worst = max(worst, float(g.max()) / max(1.0, peak))
            worst_abs, peak_all = max(worst_abs, float(g.max())), max(peak_all, peak)
            exact, total = exact + int((g == 0).sum()), total + len(s)
            rep_worst = max(rep_worst, float(_gaps(rep[i], s).max()) / max(1.0, peak))
            for t, c in enumerate(choices):     # decode step t gives the logits of step t + 1
                r = rep_choices[t]
                if c is None or r is None:
                    continue
                gap = float(g[t + 1]) / max(1.0, peak)
                if not torch.equal(c, r[i]):
                    flips += 1
                    flip_gap = max(flip_gap, gap)
                else:
                    steady += 1
                    steady_worst = max(steady_worst, gap)
        out[mode] = dict(exact=exact, total=total, worst_scaled=worst, worst_abs=worst_abs,
                         peak_abs_logit=peak_all, replay_vs_served_worst_scaled=rep_worst,
                         moe_steps_with_other_experts=flips, worst_scaled_there=flip_gap,
                         moe_steps_same_experts=steady, worst_scaled_there_same=steady_worst)
        cs.log(f"[GAP] {label} seed {seed}, alone with {mode}: {exact} of {total} served tokens "
               f"are the alone argmax; worst gap {worst:.3e} of max(1, max |logit|) "
               f"({worst_abs:.4f} absolute, max |logit| {peak_all:.3f}); the replay at b=8 against "
               f"the served logits {rep_worst:.3e}; the MoE layer chose other experts than alone "
               f"at {flips} of {flips + steady} decode steps (worst gap there {flip_gap:.3e}, "
               f"elsewhere {steady_worst:.3e})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[31, 41, 51])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.llm import deepseek as ds
    from ssp_x_vit_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("torch_mla_served_gap: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    routing = {"armed": False, "calls": []}
    _record_routing(ds, routing)
    results = []
    with torch.no_grad():
        params, cfg = cs.make_deepseek_v3(device)
        for seed in args.seeds:
            results.append(measure(params, cfg, device, seed, torch.bfloat16, None,
                                   "MoE, bf16 pools", routing))
            results.append(measure(params, cfg, device, seed, torch.int8, 128,
                                   "MoE, int8 pools, chunked prefill 128", routing))
        del params
        torch.cuda.empty_cache()
        params, cfg = cs.make_deepseek_v3(device, dense=True)
        for seed in args.seeds:
            results.append(measure(params, cfg, device, seed, torch.bfloat16, None,
                                   "all-dense, bf16 pools", routing))
    cs.log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
