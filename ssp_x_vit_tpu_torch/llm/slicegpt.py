"""SliceGPT baseline on PyTorch (counterpart of ``ssp_x_vit_tpu/llm/slicegpt.py``;
reference src/slicegpt.py:14-60 and the vendored Microsoft engine,
src/slicegpt_utils/rotate.py:124-528, layernorm_fusion.py:14-152, modules.py
RMSN, slicing_scheduler.py ConstSlicingScheduler): layernorm fusion, a PCA
rotation at every layer boundary, embedding slicing with residual shortcut
matrices.

Mechanics on the card:

- signal capture (layer-0 inputs, attention-to-MLP signals, layer outputs)
  runs the sliced blocks' own forward on the parameters' device, attention
  through the port's ``flash_attention`` (the hand-written kernel on a CUDA
  tensor, ``sdpa_reference`` on a CPU tensor);
- each covariance is summed in float64 on that device, and its ``eigh`` runs
  there too (cuSOLVER on the card, LAPACK on the CPU);
- the fusion, rotation and slicing of the weights run in float64 on the
  device, one layer at a time, and each sliced layer is rounded once to the
  compute dtype, where the JAX engine converts the whole model to float64 on
  the host first.

Slicing follows ConstSlicingScheduler with do_slice_head=False: every
boundary slices to ``new_dim = (1 - s) * d`` rounded down to a multiple of 8,
except the last layer's MLP output and the head input, which keep the full
hidden size. ``final_orientation="random"`` applies a random orthogonal
upper-left block to each Q (numpy's generator, JAX's values bit for bit).
llama-layout models (sequential blocks), phi-2 (the parallel block, one Q per
layer boundary) and OPT (LayerNorm with bias, learned positions) each take
their own fusion; gemma (scaled embeddings) and qwen3 (q/k norms) raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.llm.evaluation import _nll_sums
from ssp_x_vit_tpu_torch.llm.model import (
    LlamaConfig, Params, _attention, require_llama_config, rope_tables,
)
from ssp_x_vit_tpu_torch.ops.common import gelu

RMSN_EPS = 1e-5  # reference modules.py:20 (fixed, whatever the model's eps)


# ---------------------------------------------------------------------------
# Sliced model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlicedLlamaConfig:
    base: LlamaConfig
    new_dim: int
    do_slice_head: bool = False

    @property
    def last_dim(self) -> int:
        return self.new_dim if self.do_slice_head else self.base.hidden_size


def rmsn(x: torch.Tensor, mean_dim: int) -> torch.Tensor:
    """RMS normalization without scale, divisor fixed to the original hidden
    size even after slicing (reference modules.py:11-29)."""
    x32 = x.float()
    variance = x32.square().sum(dim=-1, keepdim=True) / mean_dim
    return (x32 * torch.rsqrt(variance + RMSN_EPS)).to(x.dtype)


def _sliced_attention(h, lp, cfg: LlamaConfig, cd, rope):
    """Attention on a sliced input basis: the model's own attention (biases,
    partial rotary for phi, no rope for OPT, GQA K/V passed un-repeated,
    Mistral's window on every layer) over the sliced kernels."""
    return _attention(h, lp, cfg, cd, cfg.sliding_window, rope)


def _sliced_mlp(h, lp, cd):
    g = h @ lp["gate_kernel"].to(cd)
    u = h @ lp["up_kernel"].to(cd)
    return (F.silu(g) * u) @ lp["down_kernel"].to(cd)


def _attn_to_mlp(x, lp, cfg: LlamaConfig, cd, rope):
    """Sequential block up to the MLP's RMSN input: x after the attention residual."""
    return x @ lp["attn_shortcut"].to(cd) + _sliced_attention(rmsn(x, cfg.hidden_size), lp,
                                                              cfg, cd, rope)


def _sliced_block(x, lp, cfg: LlamaConfig, cd, rope):
    x = _attn_to_mlp(x, lp, cfg, cd, rope)
    return x @ lp["mlp_shortcut"].to(cd) + _sliced_mlp(rmsn(x, cfg.hidden_size), lp, cd)


def _sliced_block_phi(x, lp, cfg: LlamaConfig, cd, rope):
    """phi-2 parallel-residual sliced block: one fused RMSN feeds both
    branches, one shortcut matrix (reference rotate.py:255-358)."""
    h = rmsn(x, cfg.hidden_size)
    attn_out = _sliced_attention(h, lp, cfg, cd, rope)
    hm = h @ lp["fc1_kernel"].to(cd) + lp["fc1_bias"].to(cd)
    mlp_out = gelu(hm) @ lp["fc2_kernel"].to(cd) + lp["fc2_bias"].to(cd)
    return x @ lp["attn_shortcut"].to(cd) + attn_out + mlp_out


def _sliced_block_opt(x, lp, cfg: LlamaConfig, cd, rope):
    """OPT sequential sliced block: biased attention without rope, ReLU fc
    MLP, two shortcut matrices (reference adapters/opt_adapter.py)."""
    x = _attn_to_mlp(x, lp, cfg, cd, rope)
    h = rmsn(x, cfg.hidden_size)
    hm = torch.relu(h @ lp["fc1_kernel"].to(cd) + lp["fc1_bias"].to(cd))
    mlp_out = hm @ lp["fc2_kernel"].to(cd) + lp["fc2_bias"].to(cd)
    return x @ lp["mlp_shortcut"].to(cd) + mlp_out


def _block_fn(cfg: LlamaConfig):
    return _sliced_block_phi if cfg.is_phi else _sliced_block_opt if cfg.is_opt else _sliced_block


def _embed(embed, pos_embed, input_ids, cd):
    """Token (+ OPT's learned position, HF offset 2) embeddings in ``cd``."""
    x = F.embedding(input_ids, embed).to(cd)
    if pos_embed is not None:
        pos = 2 + torch.arange(input_ids.shape[1], device=input_ids.device)
        x = x + F.embedding(pos, pos_embed).to(cd)[None]
    return x


def sliced_llama_forward(params: Params, input_ids: torch.Tensor, scfg: SlicedLlamaConfig,
                         *, compute_dtype=torch.float32) -> torch.Tensor:
    """input_ids [b, s] -> fp32 logits [b, s, V] of the sliced model."""
    cfg, cd = scfg.base, compute_dtype
    block = _block_fn(cfg)
    x = _embed(params["embed"], params.get("pos_embed"), input_ids, cd)
    rope = rope_tables(input_ids.shape[1], cfg, x.device)
    for lp in params["layers"]:
        x = block(x, lp, cfg, cd, rope)
    x = rmsn(x, cfg.hidden_size)
    logits = (x @ params["lm_head"].to(cd)).float()
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].float()
    return logits


@torch.no_grad()
def evaluate_perplexity_sliced(params, scfg: SlicedLlamaConfig, input_ids,
                               *, seq_len: int = 2048) -> float:
    """Window perplexity of the sliced model (the estimator of
    ``llm.evaluation.evaluate_perplexity``; one host read per window)."""
    device = params["embed"].device
    ids = np.asarray(input_ids).reshape(-1)
    n = ids.size // seq_len
    total, count = 0.0, 0
    for i in range(n):
        tokens = torch.from_numpy(ids[i * seq_len:(i + 1) * seq_len].astype(np.int64)).to(device)[None]
        total += float(_nll_sums(sliced_llama_forward(params, tokens, scfg), tokens).sum())
        count += seq_len - 1
    return float(np.exp(total / max(1, count)))


# ---------------------------------------------------------------------------
# Rotation engine
# ---------------------------------------------------------------------------

def covariance(signals: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum over signals of X^T X in float64 on the signals' device
    (signals: [b, s, d] each)."""
    H = None
    for X in signals:
        X = X.reshape(-1, X.shape[-1]).double()
        H = X.T @ X if H is None else H.addmm_(X.T, X)
    return H


def eigh_descending(H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped eigendecomposition in float64 on H's device, eigenvalues
    descending (reference rotate.py:502-528). H is damped in place."""
    H.diagonal().add_(0.01 * torch.mean(torch.diagonal(H)))
    eig_val, eig_vec = torch.linalg.eigh(H)
    return eig_val.flip(0), eig_vec.flip(1)


def pca_calc(signals: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped covariance eigendecomposition in float64 (reference
    rotate.py:502-528): (eigenvalues descending, eigenvectors as columns)."""
    return eigh_descending(covariance(signals))


def random_orthogonal_upper_left(total_dim: int, upper_dim: int, seed: int) -> np.ndarray:
    """Identity with a random orthogonal upper-left block (reference
    rotate.py random_orthogonal_upper_left; final_orientation='random').
    numpy, as the JAX package draws it, so the block is the same bits."""
    A = np.random.default_rng(seed).normal(size=(upper_dim, upper_dim))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    out = np.eye(total_dim)
    out[:upper_dim, :upper_dim] = Q
    return out


def _f64(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.float64)


def _fused_top(params: Params, cfg: LlamaConfig, device) -> Dict[str, torch.Tensor]:
    """Embeddings and head with the final norm fused in, float64 (reference
    layernorm_fusion.fuse_modules; phi-2 and OPT bake the mean subtraction
    into the embeddings and fold ln_final's bias into a logits bias)."""
    embed = _f64(params["embed"], device)
    head = _f64(params["lm_head"], device) if "lm_head" in params else embed.T.clone()
    out: Dict[str, torch.Tensor] = {}
    if cfg.is_phi or cfg.is_opt:
        bias = params["lm_head_bias"] if cfg.is_phi else None
        head_bias = _f64(params["ln_final_bias"], device) @ head
        out["lm_head_bias"] = head_bias if bias is None else _f64(bias, device) + head_bias
        embed = embed - embed.mean(dim=-1, keepdim=True)
        if cfg.is_opt:
            pos = _f64(params["pos_embed"], device)
            out["pos_embed"] = pos - pos.mean(dim=-1, keepdim=True)
    out["embed"] = embed
    out["lm_head"] = head * _f64(params["ln_final"], device)[:, None]
    return out


def _fused_layer(blocks: Dict[str, torch.Tensor], i: int, cfg: LlamaConfig,
                 device) -> Dict[str, torch.Tensor]:
    """Layer ``i`` in float64 with its norms folded into the following
    linears' input rows (biases too for phi-2 and OPT, whose residual writers
    get the mean subtraction baked in), as ``fuse_layernorms[_phi|_opt]`` of
    the JAX package do for every layer at once."""
    lp = {k: _f64(v[i], device) for k, v in blocks.items()}
    if not (cfg.is_phi or cfg.is_opt):
        for name in ("q_kernel", "k_kernel", "v_kernel"):
            lp[name] = lp[name] * lp["ln1"][:, None]
        for name in ("gate_kernel", "up_kernel"):
            lp[name] = lp[name] * lp["ln2"][:, None]
        return lp
    fold = [("q_kernel", "q_bias", "ln1"), ("k_kernel", "k_bias", "ln1"),
            ("v_kernel", "v_bias", "ln1"),
            ("fc1_kernel", "fc1_bias", "ln1" if cfg.is_phi else "ln2")]
    for kn, bn, ln in fold:
        lp[bn] = lp[bn] + lp[ln + "_bias"] @ lp[kn]
        lp[kn] = lp[kn] * lp[ln][:, None]
    for kn, bn in (("o_kernel", "o_bias"), ("fc2_kernel", "fc2_bias")):
        lp[kn] = lp[kn] - lp[kn].mean(dim=1, keepdim=True)
        lp[bn] = lp[bn] - lp[bn].mean()
    return lp


def _rotated(Q: torch.Tensor, dim: int, seed: int, final_orientation: str) -> torch.Tensor:
    if final_orientation != "random":
        return Q
    return Q @ torch.from_numpy(random_orthogonal_upper_left(Q.shape[0], dim, seed)).to(Q.device)


@torch.no_grad()
def slicegpt(
    params: Params,
    cfg: LlamaConfig,
    sparsity: float,
    calibration: Sequence[np.ndarray],
    *,
    final_orientation: str = "random",
    seed: int = 0,
    compute_dtype=torch.float32,
    on_phase: Optional[Callable[[str], None]] = None,
) -> Tuple[Params, SlicedLlamaConfig]:
    """Run the full SliceGPT pipeline on the parameters' device; returns
    (sliced_params, sliced_cfg).

    ``calibration``: list of [1, seq] token windows. The sequential engine
    (llama layout, OPT) takes two PCAs per layer, the attention-to-MLP signal
    and the layer output; phi-2's parallel block takes one. ``on_phase`` is
    called with the name of each part as it starts: ``capture`` (the
    forwards that make the signals), ``covariance``, ``eigh`` and
    ``rotation`` (fusing, rotating and slicing weights and signals)."""
    require_llama_config(cfg)
    if cfg.hidden_act != "silu" or cfg.scale_embeddings:
        raise ValueError(
            "slicegpt covers the silu llama-layout archs (+phi-2/OPT "
            "engines); gemma's sqrt(d)-scaled embeddings share weights with "
            "an UNSCALED tied head, so the embedding-side rotation fold "
            "does not commute — use 2SSP/depth pruning for gemma")
    if cfg.qk_norm:
        raise ValueError(
            "slicegpt cannot rotate qwen3: the per-head q/k RMSNorm sits "
            "between the projections and rope, and a hidden-dim rotation "
            "does not commute through the per-head normalization — use "
            "2SSP/depth pruning for qwen3")
    on_phase = on_phase or (lambda name: None)
    cd = compute_dtype
    d, L = cfg.hidden_size, cfg.num_layers
    new_dim = int((1 - sparsity) * d)
    new_dim -= new_dim % 8  # reference src/slicegpt.py:47-49
    print(f"New embedding dimension: {new_dim} "
          f"(sparsity {100*(1 - new_dim / d):.4f} %)")
    device = params["embed"].device
    block = _block_fn(cfg)
    parallel = cfg.is_phi
    attn_in = ("q_kernel", "k_kernel", "v_kernel") + (("fc1_kernel",) if parallel else ())
    mlp_in = ("fc1_kernel",) if cfg.is_opt else ("gate_kernel", "up_kernel")
    mlp_out = "fc2_kernel" if (cfg.is_phi or cfg.is_opt) else "down_kernel"
    # what a layer keeps of its fused leaves: the norms are folded away
    keep = attn_in + ("o_kernel", "q_bias", "k_bias", "v_bias", "o_bias", "fc1_bias",
                      "fc2_bias", mlp_out) + (() if parallel else mlp_in)

    on_phase("rotation")
    top = _fused_top(params, cfg, device)
    on_phase("capture")
    tokens_list = [torch.from_numpy(np.asarray(c).reshape(1, -1).astype(np.int64)).to(device)
                   for c in calibration]
    embed_cd = top["embed"].to(cd)
    pos_cd = top["pos_embed"].to(cd) if "pos_embed" in top else None
    rope = rope_tables(tokens_list[0].shape[1], cfg, device) if tokens_list else None
    inps = [_embed(embed_cd, pos_cd, t, cd) for t in tokens_list]   # layer-0 inputs
    del embed_cd, pos_cd

    def pca(signals, dim, orient_seed):
        on_phase("covariance")
        H = covariance(signals)
        on_phase("eigh")
        _, Q = eigh_descending(H)
        on_phase("rotation")
        return _rotated(Q, dim, orient_seed, final_orientation)

    def rotate_signals(signals, Q):
        return [(x.double() @ Q)[..., :new_dim].to(cd) for x in signals]

    Q = pca(inps, new_dim, seed)
    sliced: Params = {"embed": (top["embed"] @ Q)[:, :new_dim].to(cd)}
    if "pos_embed" in top:
        sliced["pos_embed"] = (top["pos_embed"] @ Q)[:, :new_dim].to(cd)
    layers: List[Dict[str, Any]] = []
    for idx in range(L):
        fused = _fused_layer(params["blocks"], idx, cfg, device)
        lp = {k: v for k, v in fused.items() if k in keep}
        del fused
        for name in attn_in:   # rotate + slice the inputs (kernel [in, out]: K' = Q.T @ K)
            lp[name] = (Q.T @ lp[name])[:new_dim, :]
        lp["attn_shortcut"] = Q.T[:new_dim, :]
        inps = rotate_signals(inps, Q)

        if not parallel:
            on_phase("capture")
            lp_cd = {k: v.to(cd) for k, v in lp.items()}
            mids = [_attn_to_mlp(x, lp_cd, cfg, cd, rope) for x in inps]
            del lp_cd
            Q2 = pca(mids, new_dim, seed + idx + 1)
            del mids
            lp["attn_shortcut"] = lp["attn_shortcut"] @ Q2[:, :new_dim]
            lp["o_kernel"] = (lp["o_kernel"] @ Q2)[:, :new_dim]
            if "o_bias" in lp:
                lp["o_bias"] = (lp["o_bias"] @ Q2)[:new_dim]
            lp["mlp_shortcut"] = Q2.T[:new_dim, :]
            for name in mlp_in:
                lp[name] = (Q2.T @ lp[name])[:new_dim, :]

        on_phase("capture")
        lp_cd = {k: v.to(cd) for k, v in lp.items()}
        outs = [block(x, lp_cd, cfg, cd, rope) for x in inps]   # layer outputs, pre-Q3 basis
        del lp_cd
        out_dim = d if idx == L - 1 else new_dim   # do_slice_head=False keeps the last full
        Q3 = pca(outs, out_dim, seed + idx + 1 if parallel else seed + 10_000 + idx)
        if parallel:
            lp["attn_shortcut"] = lp["attn_shortcut"] @ Q3[:, :out_dim]
            lp["o_kernel"] = (lp["o_kernel"] @ Q3)[:, :out_dim]
            lp["o_bias"] = (lp["o_bias"] @ Q3)[:out_dim]
        else:
            lp["mlp_shortcut"] = lp["mlp_shortcut"] @ Q3[:, :out_dim]
        lp[mlp_out] = (lp[mlp_out] @ Q3)[:, :out_dim]
        if mlp_out == "fc2_kernel":
            lp["fc2_bias"] = (lp["fc2_bias"] @ Q3)[:out_dim]
        layers.append({k: v.to(cd) for k, v in lp.items()})
        del lp
        # the next layer's inputs are this layer's outputs; the top of the
        # loop rotates them (and the next kernels) with Q3
        inps, Q = outs, Q3

    sliced["layers"] = layers
    sliced["lm_head"] = (Q.T @ top["lm_head"]).to(cd)
    if "lm_head_bias" in top:
        sliced["lm_head_bias"] = top["lm_head_bias"].to(cd)
    on_phase(None)
    return sliced, SlicedLlamaConfig(base=cfg, new_dim=new_dim, do_slice_head=False)
