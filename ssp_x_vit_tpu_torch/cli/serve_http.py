"""Serve an LLM over an OpenAI-compatible HTTP API (counterpart of
``ssp_x_vit_tpu/cli/serve_http.py``).

Usage (on the card; ``--backend cpu`` runs the plain PyTorch path instead)::

    python -m ssp_x_vit_tpu_torch.cli.serve_http --model ckpts/code_llm_small \\
        --port 8000 --max-batch 8 --prefix-cache

    # offline smoke (random weights, token-id prompts) on the CPU:
    python -m ssp_x_vit_tpu_torch.cli.serve_http --model tiny-random --backend cpu --port 8000
    curl -s localhost:8000/v1/completions -H 'Content-Type: application/json' \\
        -d '{"prompt": [3, 5, 7, 11], "max_tokens": 8, "temperature": 0}'

    # text prompts: the tokenizer comes from the model directory's tokenizer.json
    python -m ssp_x_vit_tpu_torch.cli.serve_http --model ckpts/code_llm_small --port 8000
    curl -s localhost:8000/v1/completions -H 'Content-Type: application/json' \\
        -d '{"prompt": "def main(", "max_tokens": 16, "temperature": 0}'

``--model`` is a ``tiny-random*`` alias, a native model directory or a local HF
directory, as for ``cli.main_llm``. ``--tokenizer DIR`` names a directory
holding a byte-level BPE ``tokenizer.json`` (``llm/tokenizer.py``); without it
the ``--model`` directory's own ``tokenizer.json`` is used when there is one,
and otherwise the server takes token-id prompts only.

``build_engine(args, model=None)`` builds the serving engine from parsed
arguments; ``model=(params, cfg)`` serves a model the caller built.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Tuple


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True,
                   help="Native or HF model directory, or a tiny-random* alias (see "
                        "cli.main_llm) for an offline smoke server")
    p.add_argument("--tokenizer", default=None,
                   help="Directory holding a byte-level BPE tokenizer.json (default: the "
                        "--model directory's, if it has one)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--served-model-name", default=None,
                   help="Name reported by /v1/models (default: --model)")
    p.add_argument("--max-batch", type=int, default=4, help="Concurrent decode slots")
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--max-context", type=int, default=2048)
    p.add_argument("--chunked-prefill", type=int, default=None,
                   help="Prefill chunk size (bounded activation memory for long prompts); "
                        "default: the whole prompt at once")
    p.add_argument("--prefix-cache", action="store_true",
                   help="Automatic prefix caching (vLLM-style)")
    p.add_argument("--kv-dtype", choices=["bf16", "int8", "fp32"], default="bf16",
                   help="KV cache pool dtype (int8 = quantized KV; fp32, a choice the JAX "
                        "CLI lacks, serves fp32 weights without rounding the cache)")
    p.add_argument("--eos-token-id", type=int, default=None,
                   help="Override the checkpoint's eos token id")
    p.add_argument("--max-tokens-cap", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0, help="Init seed for tiny-random models")
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to serve on; cuda raises when no GPU is present")
    return p


def _eos_of(args) -> Optional[int]:
    """``--eos-token-id``, else the first eos id of the model directory's config."""
    eos = args.eos_token_id
    cfg_path = os.path.join(args.model, "config.json")
    if eos is None and os.path.isdir(args.model) and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f).get("eos_token_id")
        if isinstance(raw, int):
            eos = raw
        elif isinstance(raw, list) and raw:
            eos = int(raw[0])  # multi-eos: first id; others via stop_token_ids
    return eos


def build_engine(args, model: Optional[Tuple] = None):
    """(ServingEngine, eos_token_id) for parsed arguments. ``model=(params,
    cfg)`` serves the caller's model, which must lie on ``--backend``'s device."""
    import torch

    from ssp_x_vit_tpu_torch.cli.main_llm import load_model
    from ssp_x_vit_tpu_torch.device import resolve_device
    from ssp_x_vit_tpu_torch.llm.engine import ServingEngine

    device = resolve_device(args.backend)
    if model is None:
        params, cfg = load_model(args, device)
    else:
        params, cfg = model
        if params["embed"].device.type != device.type:
            raise ValueError(f"the model is on {params['embed'].device}, --backend is {device.type}")
    engine = ServingEngine(
        params, cfg, max_batch=args.max_batch, num_pages=args.num_pages,
        page_size=args.page_size, max_context=args.max_context,
        cache_dtype={"bf16": torch.bfloat16, "int8": torch.int8, "fp32": torch.float32}[args.kv_dtype],
        chunked_prefill=args.chunked_prefill, prefix_cache=args.prefix_cache)
    return engine, _eos_of(args)


def load_server_tokenizer(args):
    """The tokenizer of ``--tokenizer``, else of the ``--model`` directory when
    it holds a ``tokenizer.json``, else None (token-id prompts only)."""
    from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

    tok_dir = args.tokenizer
    if tok_dir is None and os.path.isdir(args.model) and os.path.exists(
            os.path.join(args.model, "tokenizer.json")):
        tok_dir = args.model
    return load_tokenizer(tok_dir) if tok_dir else None


def server_kwargs(args, eos: Optional[int]) -> dict:
    """The keyword arguments of ``llm.server_http.create_server`` for parsed
    arguments, the tokenizer loaded (see ``load_server_tokenizer``)."""
    return dict(tokenizer=load_server_tokenizer(args), host=args.host, port=args.port,
                model_name=args.served_model_name or args.model, eos_token_id=eos,
                max_tokens_cap=args.max_tokens_cap)


def main(argv=None):
    from ssp_x_vit_tpu_torch.llm.server_http import serve_forever

    args = build_argparser().parse_args(argv)
    engine, eos = build_engine(args)
    try:
        kwargs = server_kwargs(args, eos)
        if kwargs["tokenizer"] is None:
            print("[serve] no tokenizer: token-id prompts only "
                  "(pass --tokenizer DIR for text prompts)", flush=True)
        serve_forever(engine, **kwargs)
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
