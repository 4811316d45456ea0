"""The port's mixture-of-experts FFN (``ssp_x_vit_tpu_torch/parallel/moe.py``)
against the JAX package's ``parallel/moe.py`` on the CPU.

Weights and inputs are drawn with numpy from a seed and handed to both
packages; everything runs in fp32 and is held within 1e-5 of max(1, max |JAX|):
``moe_ffn`` (capacity routing, top-1 and top-2, with and without overflow
drops) and ``moe_ffn_dropless`` (top-1, 2 and 3; float, int8 and packed-int4
expert stacks), their aux dicts (``load``, ``dropped``, ``aux_loss``), and the
gradients of ``mean(y^2) + 0.01 * aux_loss`` with respect to the input, the
router and the expert stacks. Ties in the router pick the lower expert index
in both; the all-expert product gives the same result in chunks of one expert;
``moe_param_specs`` equals JAX's (the mesh paths themselves run in a world of
processes, ``tests/test_torch_parallel_expert.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu.ops.pallas import quant_matmul as jqm
from ssp_x_vit_tpu.parallel import moe as J
from ssp_x_vit_tpu_torch.parallel import moe as T

TOL = 1e-5
D, F_, E = 16, 24, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(seed, e=E, d=D, f=F_):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(size=(d, e)).astype(np.float32),
            "gate_kernel": (0.2 * rng.normal(size=(e, d, f))).astype(np.float32),
            "up_kernel": (0.2 * rng.normal(size=(e, d, f))).astype(np.float32),
            "down_kernel": (0.2 * rng.normal(size=(e, f, d))).astype(np.float32)}


def np_x(seed, b=2, s=12, d=D):
    return np.random.default_rng(100 + seed).normal(size=(b, s, d)).astype(np.float32)


def both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert float(np.abs(got - want).max(initial=0.0)) <= tol * scale


def check_aux(got, want):
    for key in ("load", "dropped", "aux_loss"):
        close(got[key], want[key])


@pytest.mark.parametrize("top_k,factor", [(1, 2.0), (1, 0.05), (1, 0.5), (2, 2.0), (2, 0.05),
                                          (2, 0.5)])
def test_moe_ffn_capacity_matches_jax(top_k, factor):
    cfg_j = J.MoEConfig(D, F_, E, capacity_factor=factor, top_k=top_k)
    cfg_t = T.MoEConfig(D, F_, E, capacity_factor=factor, top_k=top_k)
    jp, tp = both(np_params(top_k))
    x = np_x(top_k)
    y_j, aux_j = J.moe_ffn(jp, jnp.asarray(x), cfg_j)
    y_t, aux_t = T.moe_ffn(tp, torch.from_numpy(x), cfg_t)
    close(y_t, y_j)
    check_aux(aux_t, aux_j)
    if factor == 0.05:   # C = 8 * k slots per expert for 24 tokens: some drop
        assert float(aux_t["dropped"]) > 0.0


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_moe_ffn_dropless_matches_jax(top_k, kind):
    tree = np_params(10 + top_k)
    if kind != "float":
        quantize = jquant.quantize_weight_int8 if kind == "int8" else jqm.quantize_weight_int4
        suffix = "_q" if kind == "int8" else "_q4"
        for name in ("gate_kernel", "up_kernel", "down_kernel"):
            codes, scale = quantize(jnp.asarray(tree.pop(name)))
            tree[name + suffix], tree[name + "_scale"] = np.asarray(codes), np.asarray(scale)
    jp, tp = both(tree)
    x = np_x(top_k)
    y_j, aux_j = J.moe_ffn_dropless(jp, jnp.asarray(x), J.MoEConfig(D, F_, E, top_k=top_k))
    y_t, aux_t = T.moe_ffn_dropless(tp, torch.from_numpy(x), T.MoEConfig(D, F_, E, top_k=top_k))
    close(y_t, y_j)
    check_aux(aux_t, aux_j)
    np.testing.assert_allclose(float(aux_t["load"].sum()), float(top_k), rtol=1e-6)


@pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_dropless"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_gradients_match_jax(fn, top_k):
    cfg_j = J.MoEConfig(D, F_, E, capacity_factor=1.0, top_k=top_k)
    cfg_t = T.MoEConfig(D, F_, E, capacity_factor=1.0, top_k=top_k)
    tree, x = np_params(20 + top_k), np_x(20 + top_k)

    def loss_j(p, xx):
        y, aux = getattr(J, fn)(p, xx, cfg_j)
        return jnp.mean(jnp.square(y)) + 0.01 * aux["aux_loss"]

    want_p, want_x = jax.grad(loss_j, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in tree.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = getattr(T, fn)(tp, tx, cfg_t)
    ((y.square().mean()) + 0.01 * aux["aux_loss"]).backward()
    close(tx.grad, want_x)
    for k in tree:
        close(tp[k].grad, want_p[k])
    assert float(tp["router"].grad.abs().sum()) > 0.0


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_router_ties_pick_the_lower_index(top_k):
    """A zero router makes every probability equal: both packages route each
    token to experts 0..k-1 with equal gates."""
    tree = np_params(30)
    tree["router"] = np.zeros_like(tree["router"])
    jp, tp = both(tree)
    x = np_x(30)
    for fn in ("moe_ffn", "moe_ffn_dropless"):
        y_j, aux_j = getattr(J, fn)(jp, jnp.asarray(x), J.MoEConfig(D, F_, E, 4.0, top_k))
        y_t, aux_t = getattr(T, fn)(tp, torch.from_numpy(x), T.MoEConfig(D, F_, E, 4.0, top_k))
        close(y_t, y_j)
        check_aux(aux_t, aux_j)
        np.testing.assert_array_equal(aux_t["load"].numpy(), [1.0] * top_k + [0.0] * (E - top_k))


def test_chunked_expert_product_and_capacity_agree(monkeypatch):
    """The all-expert product taken one expert at a time equals one chunk;
    top-2 capacity routing with room for every assignment equals dropless."""
    tp = both(np_params(40))[1]
    x = torch.from_numpy(np_x(40))
    cfg = T.MoEConfig(D, F_, E, capacity_factor=float(E), top_k=2)
    whole, _ = T.moe_ffn_dropless(tp, x, cfg)
    monkeypatch.setattr(T, "EXPERT_CHUNK_BYTES", 1)
    chunked, _ = T.moe_ffn_dropless(tp, x, cfg)
    close(chunked, whole, 1e-6)
    capped, aux = T.moe_ffn(tp, x, cfg)
    close(capped, whole)
    assert float(aux["dropped"]) == 0.0


def test_config_init_and_refusals():
    for n in (1, 7, 24, 100, 1000):
        for factor in (0.05, 1.25, 2.0):
            assert T.MoEConfig(D, F_, E, factor).capacity(n) == \
                J.MoEConfig(D, F_, E, factor).capacity(n)
    cfg = T.MoEConfig(D, F_, E)
    got = T.init_moe_params(None, cfg, device="cpu")
    want = J.init_moe_params(jax.random.PRNGKey(0), J.MoEConfig(D, F_, E))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert 0.015 < float(got["gate_kernel"].std()) < 0.025
    assert T.moe_param_specs() == {k: tuple(v) for k, v in J.moe_param_specs().items()}
    assert set(T.moe_param_specs()) == set(got)
