"""The ported ViT forward against the JAX package on the CPU, fp32.

JAX weights are carried across with ``params_from_jax`` and inputs made with
numpy, so both packages see the same numbers.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssp_x_vit_tpu.models import vit as jvit
from ssp_x_vit_tpu.ops.dispatch import set_pallas_enabled
from ssp_x_vit_tpu_torch.models import vit as tvit
from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "ckpts", "vit_procgen")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    import dataclasses

    return tvit.ViTConfig(**dataclasses.asdict(jcfg))


def _pixels(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def test_vit_forward_matches_jax_at_tiny(tiny_cfg, tiny_params):
    """Logits (atol 1e-4), ffn_stats, block_outputs and cls_repr."""
    px = _pixels(tiny_cfg, 4, 0)
    rng = np.random.default_rng(1)
    gate = np.ones(tiny_cfg.num_layers, np.float32)
    gate[1] = 0.0
    nmask = (rng.random((tiny_cfg.num_layers, tiny_cfg.intermediate_size)) > 0.25).astype(np.float32)
    jlogits, jaux = jvit.vit_forward(tiny_params, jnp.asarray(px), tiny_cfg,
                                     attn_gate=jnp.asarray(gate), neuron_mask=jnp.asarray(nmask),
                                     collect_ffn_stats=True, return_block_outputs=True)
    tparams = params_from_jax(jax.device_get(tiny_params), device="cpu")
    logits, aux = tvit.vit_forward(tparams, torch.from_numpy(px), _tcfg(tiny_cfg),
                                   attn_gate=torch.from_numpy(gate),
                                   neuron_mask=torch.from_numpy(nmask),
                                   collect_ffn_stats=True, return_block_outputs=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for key in ("ffn_stats", "block_outputs", "cls_repr"):
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


def test_vit_forward_matches_jax_with_pallas_kernels():
    """The JAX forward with its Pallas kernels active (interpret mode) at a
    config that trips both fused-kernel guards (d % 128 == 0, hd = 64, s >= 64,
    f >= 2048) against the port's plain path. atol 1e-4 on logits."""
    cfg = jvit.ViTConfig(image_size=64, patch_size=8, hidden_size=128, num_layers=2,
                         num_heads=2, intermediate_size=2048, num_classes=10)
    params = jvit.init_vit_params(jax.random.PRNGKey(3), cfg)
    px = _pixels(cfg, 2, 2)
    set_pallas_enabled(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            jlogits, jaux = jvit.vit_forward(params, jnp.asarray(px), cfg, collect_ffn_stats=True)
    finally:
        set_pallas_enabled(None)
    logits, aux = tvit.vit_forward(params_from_jax(jax.device_get(params), device="cpu"),
                                   torch.from_numpy(px), _tcfg(cfg), collect_ffn_stats=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aux["ffn_stats"].numpy(), np.asarray(jaux["ffn_stats"]),
                               rtol=1e-4, atol=1e-4)


def test_vit_forward_materialized_matches_jax(tiny_cfg, tiny_params):
    """After width (ragged kept widths) and depth materialization."""
    from ssp_x_vit_tpu.pruning import materialize_depth_pruning as jdepth
    from ssp_x_vit_tpu.pruning import materialize_width_pruning as jwidth
    from ssp_x_vit_tpu_torch.pruning import materialize_depth_pruning as tdepth
    from ssp_x_vit_tpu_torch.pruning import materialize_width_pruning as twidth

    rng = np.random.default_rng(4)
    f = tiny_cfg.intermediate_size
    keep = [np.sort(rng.choice(f, size=n, replace=False)) for n in (100, 77, 123, 90)]
    jp, jc = jdepth(*jwidth(tiny_params, tiny_cfg, keep), [0, 2])
    tp, tc = tdepth(*twidth(params_from_jax(jax.device_get(tiny_params), device="cpu"),
                            _tcfg(tiny_cfg), keep), [0, 2])
    assert tc == _tcfg(jc)
    # the port pads the physical width to a multiple of 8 with zeros (128 here)
    assert tp["blocks"]["fc1_kernel"].shape[-1] == tc.padded_intermediate_size == 128
    w = np.asarray(jp["blocks"]["fc1_kernel"]).shape[-1]
    tb = {k: v.numpy() for k, v in tp["blocks"].items()}
    np.testing.assert_array_equal(tb["fc1_kernel"][..., :w], np.asarray(jp["blocks"]["fc1_kernel"]))
    np.testing.assert_array_equal(tb["fc1_bias"][..., :w], np.asarray(jp["blocks"]["fc1_bias"]))
    np.testing.assert_array_equal(tb["fc2_kernel"][:, :w], np.asarray(jp["blocks"]["fc2_kernel"]))
    assert not tb["fc1_kernel"][..., w:].any() and not tb["fc2_kernel"][:, w:].any()
    for name in ("qkv_kernel", "ln1_scale"):
        np.testing.assert_array_equal(tb[name], np.asarray(jp["blocks"][name]))
    px = _pixels(tiny_cfg, 4, 5)
    jlogits = jvit.vit_forward_materialized(jp, jnp.asarray(px), jc)
    logits = tvit.vit_forward_materialized(tp, torch.from_numpy(px), tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)


@pytest.mark.skipif(not os.path.exists(os.path.join(CKPT, "model.npz")),
                    reason="committed trained ViT checkpoint not present")
def test_trained_checkpoint_logits_match_jax():
    """ckpts/vit_procgen loads unchanged into both packages; logits on 8
    committed held-out images agree (atol 1e-4) with identical argmax."""
    from ssp_x_vit_tpu.data.pipeline import preprocess_batch
    from ssp_x_vit_tpu.models.persistence import load_pruned_model as jload
    from ssp_x_vit_tpu_torch.data.pipeline import DataPipeline, load_procgen_slice
    from ssp_x_vit_tpu_torch.models.persistence import load_pruned_model as tload

    jparams, jcfg = jload(CKPT)
    tparams, tcfg = tload(CKPT, device="cpu")
    assert tcfg == _tcfg(jcfg)
    sl = load_procgen_slice()
    imgs, labels = sl["test_images"][:8], sl["test_labels"][:8]
    batch = DataPipeline(imgs, labels, img_size=tcfg.image_size, batch_size=8,
                         device="cpu").batches()[0]
    jpx = preprocess_batch(jnp.asarray(imgs), jcfg.image_size)
    # XLA may fuse the normalization differently: 1 ulp
    np.testing.assert_allclose(batch["pixel_values"].numpy(), np.asarray(jpx), rtol=0, atol=2e-7)
    jlogits, _ = jvit.vit_forward(jparams, jpx, jcfg)
    logits, _ = tvit.vit_forward(tparams, batch["pixel_values"], tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1))
    with open(os.path.join(CKPT, "train_meta.json")) as f:
        assert json.load(f)["val_top1"] == 1.0
    assert (logits.argmax(-1).numpy() == labels).all()
