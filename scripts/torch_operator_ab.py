#!/usr/bin/env python3
"""Times of the operator wrappers (rows 1, 2, 3, 10, 11) and of the live int8
decode step of one source tree on one card, for an A/B of two trees.

    python3 scripts/torch_operator_ab.py [--tree DIR] [--label NAME] [--out FILE]

``--tree`` (default: this checkout) is a directory holding
``ssp_x_vit_tpu_torch/`` and ``chip_smoke.py``, for example a ``git archive``
of another commit; both are imported from there, and its kernels are built
from its own sources. To compare two trees, run this script on each in turns
within one card call (A, B, B, A): numbers from different calls are not
comparable.

Measured, bf16, at ``chip_smoke.py`` phase 3's shapes: row 1
``fused_attn_block_v2`` (b=64 s=197 d=768, 12 heads), row 2
``fused_attn_block`` (b=64 s=197 d=192, 3 heads), row 3 ``fused_ffn_block``
(b=64 s=197 d=768 f=3072), row 10 ``quant4_matmul`` / ``quant_matmul`` (M=8
and M=2048, K=4096, N=11008), row 11 ``fused_mlp_int8`` (m=1 and m=8,
d=4096, f=11008): ms per call by CUDA events (``chip_smoke.time_ms``, three
runs of 50 calls), and host us per call to enqueue 200 calls behind a spin
kernel, on the wall clock and as the thread's CPU time (``time.thread_time``:
the host work of the call, which other processes on the host do not stretch
as they stretch the wall clock). Then the Llama-2-7B-width tree cut to
``chip_smoke.CONTIGUOUS_LAYERS`` (16) layers and quantized to int8, 8 prompts
of 64-512 tokens left-padded to the 512 bucket, a 640-slot bf16 cache: one
``prefill`` (ms, host clock around a synchronized call, three runs) and ms per
``decode_step`` on the host clock around synchronized loops of 16 steps and
as the thread's CPU time of the loop before its synchronize, in turns (int,
tensor, tensor, int, four times): ``pos`` a host integer, and a
0-d int64 tensor on the card stepped there, where the tree's ``decode_step``
takes one. Prints one JSON object as its last line, and writes it to
``--out`` when given.
"""

import argparse
import json
import os
import sys
import time

ITERS, RUNS = 50, 3
DECODE_STEPS, DECODE_TURNS = 16, 4


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    return ap.parse_args()


def _enqueue_us(fn, iters: int = 200):
    """(wall us, thread CPU us) per call to enqueue ``iters`` calls behind a
    spin kernel that keeps the card busy (no synchronize inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(iters):
        fn()
    wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
    torch.cuda.synchronize()
    return round(wall * 1e6 / iters, 2), round(cpu * 1e6 / iters, 2)


def _rows(cs, device) -> dict:
    """{row: {"ms": [RUNS], "host_us": x, "cpu_us": x}} for each timed wrapper call."""
    import torch

    from ssp_x_vit_tpu_torch.llm.quant import quantize_weight_int8
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffk
    from ssp_x_vit_tpu_torch.ops.kernels import quant_fused_mlp as tfm
    from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

    gen = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16
    gate = torch.ones((), dtype=torch.float32, device=device)
    calls = {}
    for row, name, (b, s, d, heads) in (("1", "fused_attn_block_v2", (64, 197, 768, 12)),
                                        ("2", "fused_attn_block", (64, 197, 192, 3))):
        inp = cs._attn_inputs(gen, b, s, d, bf, device)
        args = [inp[k] for k in ("x", "ln_scale", "ln_bias", "qkv_kernel", "qkv_bias",
                                 "proj_kernel", "proj_bias")]
        calls[f"row {row} {name}"] = (lambda w=getattr(fab, name), a=args, h=heads:
                                      w(*a, h, gate=gate))
    inp = cs._ffn_inputs(gen, 64, 197, 768, 3072, bf, device)
    args = [inp[k] for k in ("x", "ln_scale", "ln_bias", "fc1_kernel", "fc1_bias", "fc2_kernel",
                             "fc2_bias")]
    calls["row 3 fused_ffn_block"] = lambda: ffk.fused_ffn_block(*args, gate=gate)
    k, n = 4096, 11008
    scale = torch.rand(n, generator=gen, device=device) * 0.01 + 0.001
    w4 = torch.randint(-128, 128, (k // 2, n), generator=gen, device=device).to(torch.int8)
    w8 = torch.randint(-127, 128, (k, n), generator=gen, device=device).to(torch.int8)
    for m in (8, 2048):
        x = torch.randn(m, k, generator=gen, device=device).to(bf)
        calls[f"row 10 quant4_matmul M={m}"] = lambda x=x: tqm.quant4_matmul(x, w4, scale)
        calls[f"row 10 quant_matmul M={m}"] = lambda x=x: tqm.quant_matmul(x, w8, scale)
    d, f = 4096, 11008
    ws = [quantize_weight_int8(torch.randn(*shape, generator=gen, device=device)
                               * shape[0] ** -0.5) for shape in ((d, f), (d, f), (f, d))]
    mlp = [t for pair in ws for t in pair]
    for m in (1, 8):
        x = torch.randn(m, d, generator=gen, device=device).to(bf)
        calls[f"row 11 fused_mlp_int8 m={m}"] = lambda x=x: tfm.fused_mlp_int8(x, *mlp)
    out = {}
    for label, fn in calls.items():
        ms = [round(cs.time_ms(fn, iters=ITERS), 5) for _ in range(RUNS)]
        wall, cpu = _enqueue_us(fn)
        out[label] = dict(ms=ms, host_us=wall, cpu_us=cpu)
        cs.log(f"[AB] {label}: ms {ms}, host us {wall}, cpu us {cpu}")
    return out


def _decode(cs, device) -> dict:
    """Prefill ms and ms per decode step of the 16-layer int8 tree, b=8."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm import serve
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int8

    params, cfg = cs._first_layers(*cs.make_llama_7b(device), cs.CONTIGUOUS_LAYERS)
    q8 = quantize_llm_params_int8(params, cfg)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(31)
    lens = [64, 512] + sorted(rng.integers(65, 512, 6).tolist())
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int64) for n in lens]
    toks_np, pads_np, _, p_pad = serve._prepare_prompts(prompts, 640)
    toks = torch.from_numpy(toks_np.astype(np.int64)).to(device)
    pads = torch.from_numpy(pads_np.astype(np.int64)).to(device)
    layers = serve.split_layers(q8, cfg)
    ck, cv = serve.init_cache(cfg, 8, 640, torch.bfloat16, device)

    def prefill():
        return serve.prefill(q8, toks, ck, cv, cfg, pads, layers=layers)

    prefill()
    prefill_ms = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, _ = prefill()
        torch.cuda.synchronize()
        prefill_ms.append(round((time.perf_counter() - t0) * 1e3, 4))
    first = logits.argmax(-1)
    # a tree whose decode_step takes a 0-d tensor position names its type
    takes_tensor = hasattr(serve, "Position")

    def steps(tensor_pos: bool) -> float:
        """Run DECODE_STEPS steps; the thread's CPU seconds of the loop."""
        tok = first
        pos = (torch.tensor(p_pad, dtype=torch.int64, device=device) if tensor_pos
               else p_pad)
        c0 = time.thread_time()
        for _ in range(DECODE_STEPS):
            lg, _, _ = serve.decode_step(q8, tok, ck, cv, cfg, pos, pads, layers=layers)
            tok, pos = lg.argmax(-1), pos + 1
        return time.thread_time() - c0

    kinds = ("int", "tensor") if takes_tensor else ("int",)
    for kind in kinds:
        steps(kind == "tensor")
    out = {kind: [] for kind in kinds}
    cpu = {kind: [] for kind in kinds}
    for _ in range(DECODE_TURNS):
        for kind in kinds + kinds[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cpu_s = steps(kind == "tensor")
            torch.cuda.synchronize()
            out[kind].append(round((time.perf_counter() - t0) * 1e3 / DECODE_STEPS, 4))
            cpu[kind].append(round(cpu_s * 1e3 / DECODE_STEPS, 4))
    cs.log(f"[AB] 16-layer int8 prefill b=8 at 512 ms {prefill_ms}; decode step ms {out}; "
           f"its thread CPU ms {cpu}")
    return dict(prefill_ms=prefill_ms, decode_step_ms=out, decode_step_cpu_ms=cpu)


def main() -> int:
    args = _args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.ops.kernels import build

    if not os.path.abspath(build.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {build.__file__}, not the tree {tree}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    card = cs.nvidia_smi_line()
    cs.log(f"[AB] tree {tree} ({args.label}); card {card}; torch {torch.__version__}; "
           f"build {time.perf_counter() - t0:.1f} s")
    result = dict(label=args.label, tree=tree, card=card, rows=_rows(cs, device))
    result.update(_decode(cs, device))
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
