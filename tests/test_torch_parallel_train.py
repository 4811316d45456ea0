"""The port's dp x tp and FSDP train steps against the JAX package.

One gloo world of 4 CPU processes (``torch_parallel_workers``) takes one
AdamW step (lr 1e-2) from the same numpy-seeded tiny llama (4 query heads over
2 KV heads) on the same 4 x 25 tokens, in fp32:

- ``make_sharded_llama_train_step`` on a dp=2 x tp=2 mesh;
- ``make_fsdp_llama_train_step`` on a data=4 mesh;

each without clipping and with a global-norm clip that triggers. The JAX
reference is ``make_llama_train_step`` on one device with ``optax.adamw``
(after ``optax.clip_by_global_norm``); ``tests/test_parallel.py`` pins JAX's
sharded and FSDP steps to it. The ranks' shards are put back together along
their specs' axes and held to JAX's loss (rtol 1e-5) and parameters
(rtol = atol = 2e-5, JAX's own tolerance). The FSDP moments hold each sharded
leaf's 1/dp and the replicated leaves whole; a model > 1 mesh is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from torch_parallel_workers import run_world

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm.train import make_llama_train_step
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.parallel import llm_sharding as tshard

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
           intermediate_size=64)
CLIP = 1e-3


@pytest.fixture(scope="module")
def case():
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0),
                                                             jmodel.LlamaConfig(**CFG)))
    rng = np.random.default_rng(7)

    def leaf(name, shape):
        if name.startswith("ln"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    tokens = rng.integers(0, CFG["vocab_size"], size=(4, 25)).astype(np.int32)
    return tree, tokens


@pytest.fixture(scope="module")
def world(case, tmp_path_factory):
    tree, tokens = case
    return run_world(tmp_path_factory.mktemp("train_world"), 4, "train",
                     {"cfg": CFG, "params": tree, "tokens": tokens, "clip": CLIP})


@pytest.fixture(scope="module")
def jax_steps(case):
    tree, tokens = case
    out = {}
    for clip in (None, CLIP):
        opt = optax.adamw(1e-2)
        if clip is not None:
            opt = optax.chain(optax.clip_by_global_norm(clip), opt)
        params = jax.tree.map(jnp.asarray, tree)
        step = make_llama_train_step(jmodel.LlamaConfig(**CFG), opt, compute_dtype=jnp.float32)
        p, _, loss = step(params, opt.init(params), jnp.asarray(tokens))
        out[clip] = (float(loss), jax.tree.map(np.asarray, p))
    return out


def _assemble(shards, specs, axis):
    """The full tree from the ranks' shards, concatenated along each leaf's
    ``axis`` entry of its spec in rank order (replicated leaves from rank 0)."""
    def leaf(parts, spec):
        return np.concatenate(parts, axis=spec.index(axis)) if axis in spec else parts[0]

    out = {}
    for k, spec in specs.items():
        if isinstance(spec, dict):
            out[k] = {bk: leaf([s[k][bk] for s in shards], bs) for bk, bs in spec.items()}
        else:
            out[k] = leaf([s[k] for s in shards], spec)
    return out


def _close(got, want):
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("clip", [None, CLIP])
def test_dp_tp_step_matches_jax(world, jax_steps, case, clip):
    loss, want = jax_steps[clip]
    for out in world:
        np.testing.assert_allclose(out[f"tp_{clip}"][0], loss, rtol=1e-5)
    specs = tshard.llm_param_specs_like(tckpt.llm_params_from_jax(case[0], device="cpu"))
    for group in ((0, 1), (2, 3)):   # each data rank's model group holds the whole tree
        _close(_assemble([world[r][f"tp_{clip}"][1] for r in group], specs, "model"), want)


@pytest.mark.parametrize("clip", [None, CLIP])
def test_fsdp_step_matches_jax(world, jax_steps, clip):
    loss, want = jax_steps[clip]
    specs = world[0]["fsdp_specs"]
    assert "data" in specs["blocks"]["q_kernel"]   # block kernels really sharded
    for out in world:
        np.testing.assert_allclose(out[f"fsdp_{clip}"][0], loss, rtol=1e-5)
    _close(_assemble([out[f"fsdp_{clip}"][1] for out in world], specs, "data"), want)


def test_fsdp_moments_hold_a_quarter(world, case):
    from jax.sharding import PartitionSpec

    from ssp_x_vit_tpu.parallel.llm_sharding import fsdp_llama_param_specs_like

    specs = world[0]["fsdp_specs"]
    tree = case[0]
    assert specs == jax.tree.map(tuple, fsdp_llama_param_specs_like(tree, 4),
                                 is_leaf=lambda x: isinstance(x, PartitionSpec))
    expected = 0
    for k, v in tree.items():
        for name, leaf in (v.items() if isinstance(v, dict) else [(k, v)]):
            spec = specs[k][name] if isinstance(v, dict) else specs[k]
            expected += leaf.size // 4 if "data" in spec else leaf.size
    out = world[0]
    assert out["moment_elems"] == expected < 0.3 * out["full_elems"]
    assert "model=1 mesh" in out["refuse_fsdp_tp"]

