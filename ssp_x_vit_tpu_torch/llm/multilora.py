"""Multi-LoRA serving: one batched generation over per-request adapters
(counterpart of ``ssp_x_vit_tpu/llm/multilora.py``, with its contract).

- Adapters (``llm/lora.py`` trees ``{target: {"a": [L, d, r], "b": [L, r,
  n]}}``) stack into bank tensors ``[L, R + 1, d, r]`` / ``[L, R + 1, r, n]``;
  slot 0 is the identity (zeros), so id 0 serves the base model in the same
  batch, and slot i is ``adapters[i - 1]``. The ``alpha / r`` scale is folded
  into b in fp32; the bank stays float (fp32 by default) whatever the base's
  dtype, on a quantized base too.
- ``attach_lora_bank`` places the bank in ``params["blocks"]`` under
  ``<target>_lora_a`` / ``<target>_lora_b``, so ``serve.split_layers`` hands
  each layer its slices beside the base kernels.
- Each request carries an adapter id; the serving layers add
  ``(x @ A[id]) @ B[id]`` to the target projection (``lora_delta``: two
  batched products in the compute dtype, as the JAX package's two einsums),
  after the packed ``qkv`` split. Only q/k/v/o deltas are applied, so MLP
  targets are refused at build time.

JAX has no Pallas kernel here: plain ops are the counterpart. The ids are
fixed for a generation, so ``serve.generate_kv_scan`` gathers each row's
slices once (``gather_lora_rows``) instead of at every step: the same values,
bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ssp_x_vit_tpu_torch.llm.model import Params

LORA_SUFFIX_A = "_lora_a"
LORA_SUFFIX_B = "_lora_b"
# a row-gathered slice of one layer: [b, d, r] / [b, r, n] in the compute dtype
ROWS_SUFFIX_A = "_lora_rows_a"
ROWS_SUFFIX_B = "_lora_rows_b"

# Targets the serving layers apply deltas for (serve._block_qkv + _proj_o).
SERVABLE_TARGETS = ("q_kernel", "k_kernel", "v_kernel", "o_kernel")


def build_lora_bank(adapters: Sequence[Params], *, alpha: float = 16.0,
                    dtype=torch.float32) -> Params:
    """Stack adapter trees into serving bank tensors: ``{"<t>_lora_a": [L,
    R + 1, d, r], "<t>_lora_b": [L, R + 1, r, n]}`` with slot 0 = identity
    (zeros) and ``alpha / r`` folded into b (computed in fp32)."""
    if not adapters:
        raise ValueError("need at least one adapter")
    targets = sorted(adapters[0])
    unsupported = [t for t in targets if t not in SERVABLE_TARGETS]
    if unsupported:
        raise ValueError(
            f"multi-LoRA serving applies deltas on {SERVABLE_TARGETS} only; "
            f"adapter targets {unsupported} would be silently ignored "
            "(merge_lora those adapters instead)")
    bank: Params = {}
    for t in targets:
        a_list, b_list = [], []
        for ad in adapters:
            if set(ad) != set(targets):
                raise ValueError("adapters target different key sets")
            r = ad[t]["a"].shape[-1]
            a_list.append(ad[t]["a"].to(dtype))
            b_list.append((ad[t]["b"].float() * (alpha / r)).to(dtype))
        a = torch.stack(a_list, dim=1)                          # [L, R, d, r]
        b = torch.stack(b_list, dim=1)                          # [L, R, r, n]
        bank[t + LORA_SUFFIX_A] = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        bank[t + LORA_SUFFIX_B] = torch.cat([torch.zeros_like(b[:, :1]), b], dim=1)
    return bank


def attach_lora_bank(params: Params, bank: Params) -> Params:
    """The bank in ``params["blocks"]`` (shared, not copied), so the serving
    layers slice it per layer beside the base kernels. A bank target with no
    kernel (plain, ``_q``, ``_q4`` or packed) in the blocks is refused."""
    blocks = dict(params["blocks"])
    for k, v in bank.items():
        base = k[: -len(LORA_SUFFIX_A)]
        if base not in blocks and not any(b.startswith(base) for b in blocks):
            raise ValueError(f"bank target {base} not in params blocks")
        blocks[k] = v
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def lora_delta(x: torch.Tensor, bp: Params, target: str, lora_ids: Optional[torch.Tensor],
               compute_dtype) -> Optional[torch.Tensor]:
    """Per-row adapter delta of one projection, ``(x @ A[id]) @ B[id]``: x
    ``[b, s, d]``; the layer's bank slices in ``bp`` (a ``[R, d, r]``, b ``[R,
    r, n]``), or the rows ``gather_lora_rows`` gathered for these ids; lora_ids
    ``[b]``. Returns ``[b, s, n]``, or None when the target has no bank or the
    ids are None."""
    if lora_ids is None:
        return None
    a = bp.get(target + ROWS_SUFFIX_A)
    b = bp.get(target + ROWS_SUFFIX_B)
    if a is None:
        a, b = bp.get(target + LORA_SUFFIX_A), bp.get(target + LORA_SUFFIX_B)
        if a is None or b is None:
            return None
        a, b = a[lora_ids].to(compute_dtype), b[lora_ids].to(compute_dtype)
    return torch.bmm(torch.bmm(x, a), b)


def gather_lora_rows(bp: Params, lora_ids: torch.Tensor, compute_dtype) -> Params:
    """One layer's parameters with each bank slice's rows for ``lora_ids``
    gathered and cast once (``<t>_lora_rows_a`` / ``_b``): ``lora_delta``
    then runs only its two products. The bank slices stay in the dict."""
    out = dict(bp)
    for k in bp:
        if k.endswith(LORA_SUFFIX_A):
            t = k[: -len(LORA_SUFFIX_A)]
            out[t + ROWS_SUFFIX_A] = bp[k][lora_ids].to(compute_dtype)
            out[t + ROWS_SUFFIX_B] = bp[t + LORA_SUFFIX_B][lora_ids].to(compute_dtype)
    return out
