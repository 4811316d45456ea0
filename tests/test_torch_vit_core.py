"""The ViT attention blocks' plain versions and the attention core's check,
on the CPU.

- The plain attention blocks (``fused_attn_block_v2_plain`` /
  ``fused_attn_block_plain``) take the plain core on every device, so a card
  check holds the block kernels against plain PyTorch and never against the
  flash kernel.
- In bf16 they keep the Pallas kernels' rounding points (q/k/v rounded after
  the bias, the full row's softmax divided by its sum and rounded before
  P @ V): held against ``ssp_x_vit_tpu/ops/pallas/fused_attn_block.py`` in
  interpret mode within 2e-2 of max(1, max |ref|) (bf16 rounds the block's
  intermediates at a few points that differ: the LN output, q/k/v, P and the
  attention output are each one bf16 rounding, ~2^-8 relative).
- The card's check of the core alone is ``flash_errors`` / ``flash_agrees``
  on [b, h, s, hd] views; it must reject a copy of the plain core's output
  with the ragged last query tile of each image zeroed (rows 192-196 at
  s = 197) and one with two heads swapped.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssp_x_vit_tpu.ops.pallas import fused_attn_block as jfab
from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as tfab
from ssp_x_vit_tpu_torch.ops.kernels.flash_attention import flash_agrees, flash_errors

ROWS = ("fused_attn_block_v2", "fused_attn_block")


def _weights(rng, d):
    return dict(
        lns=1.0 + 0.1 * rng.normal(size=d), lnb=0.1 * rng.normal(size=d),
        wqkv=rng.normal(size=(d, 3 * d)) * d ** -0.5, bqkv=rng.normal(size=3 * d) * 0.1,
        wproj=rng.normal(size=(d, d)) * d ** -0.5, bproj=rng.normal(size=d) * 0.1)


def _block_args(seed, b, s, d):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d))
    w = _weights(rng, d)
    return [x] + [w[k] for k in ("lns", "lnb", "wqkv", "bqkv", "wproj", "bproj")]


@pytest.mark.parametrize("row", ROWS)
def test_plain_attention_blocks_take_the_plain_core(row, monkeypatch):
    """(a) The plain version asks multi_head_attention for the plain core
    (use_flash=False), whatever the device."""
    calls = []
    original = tfab.multi_head_attention

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return original(*args, **kwargs)

    monkeypatch.setattr(tfab, "multi_head_attention", spy)
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in _block_args(0, 2, 9, 16)]
    getattr(tfab, row + "_plain")(*args, 2, gate=0.5)
    assert calls and all(kw.get("use_flash") is False for kw in calls), calls


@pytest.mark.parametrize("row,s,d,heads", [
    ("fused_attn_block_v2", 197, 128, 2),
    ("fused_attn_block", 65, 96, 3),
])
def test_plain_attention_blocks_match_pallas_in_bf16(row, s, d, heads):
    """(b) Rows 1-2 in bf16: the port (its plain version on the CPU) against
    the Pallas kernel in interpret mode, gates 0.5 and 1."""
    args = _block_args(1, 2, s, d)
    args_j = [jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16) for a in args]
    args_t = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in args]
    for gate in (0.5, 1.0):
        with pltpu.force_tpu_interpret_mode():
            ref = getattr(jfab, row)(*args_j, heads, eps=1e-12, gate=gate)
        ref = np.asarray(ref.astype(jnp.float32))
        port = getattr(tfab, row)(*args_t, heads, eps=1e-12, gate=torch.tensor(gate))
        assert port.dtype == torch.bfloat16
        err = np.abs(port.float().numpy() - ref).max()
        assert err <= 2e-2 * max(1.0, np.abs(ref).max()), (gate, err)


def _core(dtype, b=2, s=197, heads=3, hd=64, seed=2):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b * s, 3 * heads * hd)).astype(np.float32)).to(dtype)
    return tfab.head_view(tfab.attention_core_plain(qkv, b, s, heads), b, s, heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_core_check_rejects_a_zeroed_ragged_tile_and_a_head_swap(dtype):
    """(c) flash_errors on the core's [b, h, s, hd] view: the plain output
    passes against itself; zeroing the ragged last query tile of each image
    (rows 192-196 of 197) or swapping two heads fails."""
    ref = _core(dtype)
    zeroed, swapped = ref.clone(), ref.clone()
    zeroed[:, :, 192:197] = 0
    swapped[:, [0, 1]] = ref[:, [1, 0]]
    assert flash_agrees(ref.clone(), ref)
    assert not flash_agrees(zeroed, ref), flash_errors(zeroed, ref)
    assert not flash_agrees(swapped, ref), flash_errors(swapped, ref)


def test_core_plain_is_the_blocks_core():
    """attention_core_plain on the fused QKV buffer is the core that the plain
    block computes: heads side by side, sdpa_reference per head."""
    from ssp_x_vit_tpu_torch.ops.attention import sdpa_reference

    b, s, heads, hd = 2, 11, 3, 8
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((b * s, 3 * heads * hd)).astype(np.float32))
    got = tfab.attention_core_plain(qkv, b, s, heads)
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in qkv.split(heads * hd, dim=1))
    want = sdpa_reference(q, k, v).transpose(1, 2).reshape(b * s, heads * hd)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
