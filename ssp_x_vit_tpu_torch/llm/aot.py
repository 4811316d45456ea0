"""Ahead-of-time serving artifacts on ``torch.export`` (counterpart of
``ssp_x_vit_tpu/llm/aot.py``).

Production serving should not need the Python model code or a trace at
process start: this module exports the serving-step computations (prefill and
decode step) and the ViT classification forward as ``torch.export`` programs,
serialized with ``torch.export.save``, that a process loads with
``load_artifact`` and calls without importing ``llm/serve.py``,
``llm/model.py`` or ``models/vit.py``. Parameters and caches stay runtime
INPUTS (never constants of the program), so one artifact serves every
checkpoint of its configuration, quantized trees included (the tree's
structure is part of the exported signature).

Kernels: an artifact exported from CUDA tensors holds the hand-written kernels
of its path as ``torch.ops.ssp`` custom operators (``ops/kernels/library.py``:
rows 1-3 on the ViT forward, row 11 on an unpacked int8 llama tree, row 10 on
an int4 one); they launch, and count in ``launch_counts``, when the artifact
runs. An artifact exported from CPU tensors holds no ``ssp`` operator (the
plain versions are traced). Each artifact runs on the device type it was
exported from; calling it with tensors on another device raises, nothing is
moved. The JAX package cross-lowers for a TPU on any host (``platforms=``);
here the device is that of the parameters (the example inputs are made
there), so a CUDA artifact is exported on a machine with a card.

Notes:
- Caches are written IN PLACE: the artifact writes the new rows into the
  cache tensors it is given and returns those same objects (JAX's artifacts
  are functional and return new buffers; its note budgets two cache
  buffers). One cache buffer per deployment is enough here.
- One artifact per (batch, prompt bucket): shapes are static, as in JAX.
- Dict keys: torch's pytree pins a dict's key order in the input spec, so the
  export and every call take the trees with their keys sorted
  (:func:`canonical`); a tree read from disk in another order is accepted.
- Positions are int64: tokens ``[b, p_pad]`` / ``[b]``, ``pad_lens [b]`` and the
  decode position, a 0-d tensor read on the device (no host read).
"""

from __future__ import annotations

import glob
import io
import os
from typing import Any, Dict, Optional, Sequence

import torch
import torch.utils._pytree as pytree

# An artifact exported from CUDA tensors holds these operators: loading one
# needs them registered. The registry imports no model code.
from ssp_x_vit_tpu_torch.ops.kernels import library

SUFFIX = ".pt2"


def canonical(tree: Any) -> Any:
    """``tree`` with every dict's keys in sorted order (lists and tuples kept):
    the key order an artifact's input spec holds."""
    if isinstance(tree, dict):
        return {k: canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(canonical(v) for v in tree)
    return tree


def _tree_device(tree) -> torch.device:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("the tree holds no tensor")


class _Program(torch.nn.Module):
    """The function to export as a module without parameters or buffers:
    every tensor it reads comes in as an argument."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _drop_no_ops(program: torch.export.ExportedProgram) -> None:
    """Remove the nodes that do nothing when the program runs: the dtype
    asserts export puts before each ``.to`` and the ``.to`` calls whose input
    already has the target dtype (eager returns the input itself). Each is a
    dispatched call, ~40% of a decode step's nodes, paid on the host at every
    step."""
    aten = torch.ops.aten
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is aten._assert_tensor_metadata.default and not node.users:
            graph.erase_node(node)
        elif (node.target is aten.to.dtype and len(node.args) == 2 and not node.kwargs
              and node.args[0].meta["val"].dtype == node.meta["val"].dtype):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()


def _no_grad_body(fn):
    """The function under a ``@torch.no_grad()`` decorator. The export already
    runs without gradients; the decorator's own switch would be traced as a
    grad-mode region that export then splits into submodules (seconds of
    export time a program, and nodes that do nothing)."""
    return fn.__wrapped__


def _export(fn, args) -> bytes:
    with torch.no_grad():
        program = torch.export.export(_Program(fn), tuple(canonical(a) for a in args),
                                      strict=False)
    _drop_no_ops(program)
    # torch.export.save stores the example inputs beside the program: here the
    # parameters and caches themselves (GBs at 7B widths), which an artifact
    # must not carry
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _example_caches(cfg, batch: int, max_len: int, cache_dtype, rolling: Optional[int],
                    device: torch.device):
    """Rolling artifacts MUST trace with exactly W cache slots: the rolling
    mask arithmetic (age = (g - slot) mod W) is only right when the slot
    count equals W (``serve.init_rolling_cache``)."""
    from ssp_x_vit_tpu_torch.llm.serve import init_cache

    return init_cache(cfg, batch, rolling if rolling is not None else max_len, cache_dtype,
                      device)


def export_prefill(params, cfg, *, batch: int, p_pad: int, max_len: int,
                   cache_dtype=torch.bfloat16, rolling: Optional[int] = None) -> bytes:
    """Serialize the prefill step for LEFT-padded ``[batch, p_pad]`` prompts
    into a ``[*, max_len, ...]`` cache, on the device of ``params``. Call
    signature of the artifact: (params, tokens int64 [b, p_pad], cache_k,
    cache_v, pad_lens int64 [b]) -> (logits [b, V] fp32, cache_k, cache_v),
    the caches written in place and returned."""
    from ssp_x_vit_tpu_torch.llm.serve import prefill

    def fn(p, tokens, ck, cv, pad_lens):
        return _no_grad_body(prefill)(p, tokens, ck, cv, cfg, pad_lens, rolling=rolling)

    device = _tree_device(params)
    ck, cv = _example_caches(cfg, batch, max_len, cache_dtype, rolling, device)
    return _export(fn, (params, torch.zeros((batch, p_pad), dtype=torch.int64, device=device),
                        ck, cv, torch.zeros((batch,), dtype=torch.int64, device=device)))


def export_decode_step(params, cfg, *, batch: int, max_len: int, cache_dtype=torch.bfloat16,
                       rolling: Optional[int] = None) -> bytes:
    """Serialize one greedy-serving decode step. Call signature: (params,
    token int64 [b], cache_k, cache_v, pos int64 [], pad_lens int64 [b]) ->
    (logits [b, V] fp32, cache_k, cache_v), the caches written in place and
    returned; ``pos`` is read on the device only. A contiguous cache takes
    ``pos < max_len`` (nothing checks it on the host: a row past the end
    raises on the CPU and is a device-side assert on the card, which ends the
    process's CUDA context, where JAX's artifact clamps the row); a rolling
    cache writes at ``pos % rolling``."""
    from ssp_x_vit_tpu_torch.llm.serve import decode_step

    def fn(p, token, ck, cv, pos, pad_lens):
        return _no_grad_body(decode_step)(p, token, ck, cv, cfg, pos, pad_lens,
                                          rolling=rolling)

    device = _tree_device(params)
    ck, cv = _example_caches(cfg, batch, max_len, cache_dtype, rolling, device)
    return _export(fn, (params, torch.zeros((batch,), dtype=torch.int64, device=device), ck, cv,
                        torch.zeros((), dtype=torch.int64, device=device),
                        torch.zeros((batch,), dtype=torch.int64, device=device)))


def export_serving_bundle(params, cfg, *, batch: int, prompt_buckets: Sequence[int],
                          max_len: int, cache_dtype=torch.bfloat16,
                          rolling: Optional[int] = None) -> Dict[str, bytes]:
    """Artifact set for a serving deployment: one prefill per prompt bucket and
    one decode step. Returns ``{"prefill_<p_pad>": bytes, "decode": bytes}``."""
    bundle = {f"prefill_{p}": export_prefill(params, cfg, batch=batch, p_pad=p, max_len=max_len,
                                             cache_dtype=cache_dtype, rolling=rolling)
              for p in prompt_buckets}
    bundle["decode"] = export_decode_step(params, cfg, batch=batch, max_len=max_len,
                                          cache_dtype=cache_dtype, rolling=rolling)
    return bundle


def export_vit_classify(params, cfg, *, batch: int, compute_dtype=torch.bfloat16) -> bytes:
    """Serialize the ViT classification forward (dense or width/depth-
    materialized trees: a config with pruned attention blocks takes
    ``vit_forward_materialized``). Call signature: (params, pixels
    [b, H, W, 3] in ``compute_dtype``) -> logits [b, classes]."""
    from ssp_x_vit_tpu_torch.models.vit import vit_forward, vit_forward_materialized

    materialized = bool(getattr(cfg, "pruned_attention_blocks", ()))

    def fn(p, pixels):
        if materialized:
            return vit_forward_materialized(p, pixels, cfg, compute_dtype=compute_dtype)
        return vit_forward(p, pixels, cfg, compute_dtype=compute_dtype)[0]

    device = _tree_device(params)
    return _export(fn, (params, torch.zeros((batch, cfg.image_size, cfg.image_size, 3),
                                            dtype=compute_dtype, device=device)))


class Artifact:
    """A deserialized serving artifact; run it with ``call(*args)``, the
    signature its export function states. No model code or trace is
    involved: the program's graph runs as it was exported."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        specs = program.graph_signature.input_specs
        user = {s.arg.name for s in specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT}
        devices = {n.meta["val"].device for n in program.graph.nodes
                   if n.op == "placeholder" and n.name in user
                   and isinstance(n.meta.get("val"), torch.Tensor)}
        if len(devices) != 1:
            raise ValueError(f"an artifact's inputs lie on one device, these on {devices}")
        self.device = devices.pop()
        self._module = program.module()

    def operator_counts(self) -> Dict[str, int]:
        """Nodes of each ``ssp`` operator in the program's graph."""
        counts: Dict[str, int] = {}
        for node in self.program.graph.nodes:
            target = node.target
            if node.op == "call_function" and getattr(target, "namespace", None) == \
                    library.NAMESPACE:
                name = target.name().split("::")[1].split(".")[0]
                counts[name] = counts.get(name, 0) + 1
        return counts

    def call(self, *args):
        args = tuple(canonical(a) for a in args)
        for leaf in pytree.tree_leaves(args):
            if isinstance(leaf, torch.Tensor) and leaf.device != self.device:
                raise ValueError(f"this artifact runs on {self.device}; an input is on "
                                 f"{leaf.device} (nothing is moved)")
        with torch.no_grad():
            return self._module(*args)


def load_artifact(blob: bytes) -> Artifact:
    """Deserialize a serving artifact (bytes of ``torch.export.save``)."""
    return Artifact(torch.export.load(io.BytesIO(blob)))


def save_bundle(bundle: Dict[str, bytes], path: str) -> None:
    """Write a bundle to ``<path>/<name>.pt2`` files."""
    os.makedirs(path, exist_ok=True)
    for name, blob in bundle.items():
        with open(os.path.join(path, name + SUFFIX), "wb") as f:
            f.write(blob)


def load_bundle(path: str) -> Dict[str, Artifact]:
    """Read a :func:`save_bundle` directory back into ``{name: Artifact}``."""
    out = {}
    for fp in sorted(glob.glob(os.path.join(path, "*" + SUFFIX))):
        with open(fp, "rb") as f:
            out[os.path.basename(fp)[: -len(SUFFIX)]] = load_artifact(f.read())
    return out
