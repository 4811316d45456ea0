"""The flash kernels' agreement criterion (``flash_errors`` / ``flash_agrees``
in ``ops/kernels/flash_attention.py``), on the CPU with the plain versions:
it accepts the plain result computed another way (fp32 math rounded once),
and rejects a copy with one late 64-row query tile zeroed or with two heads
swapped, for the output and each gradient."""

import numpy as np
import pytest
import torch

from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa


def _plain(dtype, seed=0, b=1, h=4, s=512, hd=64):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, h, s, hd)).astype(np.float32)).to(dtype)
                  for _ in range(4))
    out = tfa.flash_attention_plain(q, k, v, causal=True)
    return (q, k, v, g), dict(zip(("output", "dq", "dk", "dv"),
                                  (out, *tfa.flash_attention_backward_plain(q, k, v, g, causal=True))))


@pytest.mark.parametrize("what", ["output", "dq", "dk", "dv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_criteria_reject_a_zeroed_late_tile_and_a_head_swap(dtype, what):
    _, plain = _plain(dtype)
    ref = plain[what]
    zeroed, swapped = ref.clone(), ref.clone()
    zeroed[:, :, 384:448] = 0
    swapped[:, [0, 1]] = ref[:, [1, 0]]
    assert tfa.flash_agrees(ref.clone(), ref)
    assert not tfa.flash_agrees(zeroed, ref), tfa.flash_errors(zeroed, ref)
    assert not tfa.flash_agrees(swapped, ref), tfa.flash_errors(swapped, ref)


@pytest.mark.parametrize("what", ["output", "dq", "dk", "dv"])
def test_flash_criteria_accept_fp32_math_rounded_once(what):
    """The bf16 plain result against the same function in fp32 on the same
    bf16 inputs, rounded to bf16 once: the rounding points differ as the
    kernel's do (p and ds rounded before their products)."""
    (q, k, v, g), plain = _plain(torch.bfloat16)
    out32 = tfa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    grads32 = tfa.flash_attention_backward_plain(q.float(), k.float(), v.float(), g.float(),
                                                 causal=True)
    other = dict(zip(("output", "dq", "dk", "dv"), (out32, *grads32)))[what].bfloat16()
    assert tfa.flash_agrees(other, plain[what]), tfa.flash_errors(other, plain[what])
