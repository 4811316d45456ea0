"""The port's flash-attention backward against the JAX package's on the CPU.

``flash_attention_backward_plain`` (the explicit fp32 formula the port uses on
CPU tensors and holds its CUDA kernels to) against the Pallas backwards
``_flash_backward_pallas`` (single pass) and ``_flash_backward_streaming``
(dq pass, then dk/dv pass), run in interpret mode as
``tests/test_pallas_kernels.py`` runs them, and against autograd through the
plain forward. Inputs come from numpy seeds. Tolerance: max |diff| over
max(1, max |reference|) <= 2e-5, fp32 on both sides in another summation
order. The cases cover causal and full attention, GQA, a sliding window that
leaves the padded rows of the Pallas tiles fully masked, and softcap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssp_x_vit_tpu.ops.pallas import flash_attention as jfa
from ssp_x_vit_tpu_torch.ops.attention import flash_attention
from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa
from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

CASES = {  # b, h, hkv, s, hd, causal, window, softcap
    "causal-gqa": (1, 4, 2, 150, 32, True, None, None),
    "full-mha": (2, 2, 2, 130, 16, False, None, None),
    "window-masked-rows": (1, 2, 1, 200, 32, True, 16, None),
    "softcap-window-gqa": (1, 4, 1, 140, 32, True, 48, 20.0),
}
TOL = 2e-5


def _inputs(case, seed=0):
    b, h, hkv, s, hd, causal, window, softcap = CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd), (b, h, s, hd))]
    return arrays, dict(causal=causal, window=window, softcap=softcap)


def _scaled_err(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.detach().numpy() - ref).max() / max(1.0, np.abs(ref).max()))


# the streaming pair is the costlier one in interpret mode: it takes the two
# cases that hold every feature (GQA, window, masked rows, softcap)
PAIRS = [(case, "single-pass") for case in sorted(CASES)] + [
    ("window-masked-rows", "streaming"), ("softcap-window-gqa", "streaming")]


@pytest.mark.parametrize("case,kernel", PAIRS)
def test_plain_backward_matches_the_pallas_backward(case, kernel):
    (q, k, v, g), kw = _inputs(case)
    fn = jfa._flash_backward_pallas if kernel == "single-pass" else jfa._flash_backward_streaming
    with pltpu.force_tpu_interpret_mode():
        ref = fn(*(jnp.asarray(a) for a in (q, k, v, g)), **kw)
    got = tfa.flash_attention_backward_plain(*(torch.from_numpy(a) for a in (q, k, v, g)), **kw)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape
        assert _scaled_err(a, r) <= TOL, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_of_the_port_takes_the_plain_backward(case):
    """Autograd through the plain forward (``sdpa_reference`` on repeated K/V)
    agrees with the explicit formula, and the public entry under autograd on
    CPU tensors returns exactly the plain backward and launches nothing."""
    (q, k, v, g), kw = _inputs(case, seed=1)
    window = kw["window"]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    g = torch.from_numpy(g)
    want = tfa.flash_attention_backward_plain(q.detach(), k.detach(), v.detach(), g, **kw)

    ref = torch.autograd.grad(tfa.flash_attention_plain(q, k, v, **kw), (q, k, v), g)
    for name, a, r in zip(("dq", "dk", "dv"), want, ref):
        assert _scaled_err(a, r.numpy()) <= TOL, name

    reset_launch_counts()
    out = flash_attention(q, k, v, causal=kw["causal"], window=window, softcap=kw["softcap"])
    got = torch.autograd.grad(out, (q, k, v), g)
    for a, r in zip(got, want):
        assert torch.equal(a, r)
    assert all(n == 0 for n in launch_counts.values())
