"""The ``torch.library`` custom operators of rows 1-4, 10 and 11
(``ssp_x_vit_tpu_torch/ops/kernels/library.py``).

On the CPU: each operator's fake implementation, run on fake tensors (what a
``torch.export`` trace runs), gives outputs of the plain version's shapes and
dtypes on the same real CPU inputs, at several shapes each (ragged rows,
int8 and int4 weights, odd head counts, with and without the stats, with and
without the residual); and a CPU call of each wrapper runs its plain version
without reaching the operator (no ``ssp`` op dispatched, no launch counted).
On the card (``-m cuda``, skipped here): ``torch.library.opcheck`` on each
operator at the same cases (schema, fake against real outputs, autograd
registration, traced dispatch). This file imports no JAX, so the card runs it
with ``--noconftest``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffk
from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, library, reset_launch_counts
from ssp_x_vit_tpu_torch.ops.kernels import quant_fused_mlp as tfm
from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm


def _cases(device, dtype):
    """(operator name, operator args, plain call, wrapper call) at several
    shapes; inputs from a numpy seed."""
    rng = np.random.default_rng(0)

    def rn(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32)).to(
            device=device, dtype=dtype)

    def codes(*shape, lo=-127, hi=128):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.int8)).to(device)

    def scale(n):
        return torch.from_numpy(rng.uniform(0.01, 0.03, size=n).astype(np.float32)).to(device)

    out = []
    for (b, s, d, heads), residual, with_gate in (((2, 9, 32, 4), True, False),
                                                   ((3, 17, 48, 2), False, True),
                                                   ((1, 5, 24, 3), True, True),
                                                   ((2, 4, 16, 1), False, False)):
        x = rn(b, s, d)
        w = [rn(d, std=0.1) + 1, rn(d, std=0.1), rn(d, 3 * d, std=d ** -0.5), rn(3 * d, std=0.1),
             rn(d, d, std=d ** -0.5), rn(d, std=0.1) if residual else None]
        gate = torch.full((), 0.5, device=device) if with_gate else None
        name = "fused_attn_block_v2" if heads % 2 == 0 else "fused_attn_block"
        out.append((name, (x, *w, gate, heads, 1e-12, residual),
                    lambda x=x, w=w, g=gate, h=heads, r=residual, n=name: (
                        getattr(fab, n + "_plain")(x, *w, h, gate=g, residual=r)),
                    lambda x=x, w=w, g=gate, h=heads, r=residual, n=name: (
                        getattr(fab, n)(x, *w, h, gate=g, residual=r))))
    for (b, s, d, f), stats, masked, residual in (((2, 9, 32, 40), True, True, True),
                                                  ((3, 5, 16, 24), False, False, False),
                                                  ((1, 17, 24, 72), True, False, False)):
        x = rn(b, s, d)
        ln = [rn(d, std=0.1) + 1, rn(d, std=0.1)]
        w = [rn(d, f, std=d ** -0.5), rn(f, std=0.1), rn(f, d, std=f ** -0.5),
             rn(d, std=0.1) if residual else None]
        mask = (rn(f) > 0).to(dtype) if masked else None
        gate = None if residual else torch.full((), 0.25, device=device)
        out.append(("fused_ffn_block", (x, *ln, *w, mask, gate, stats, 1e-12, residual),
                    lambda x=x, ln=ln, w=w, m=mask, g=gate, st=stats, r=residual: (
                        ffk.fused_ffn_block_plain(x, *ln, *w, neuron_mask=m, gate=g,
                                                  collect_stats=st, residual=r)),
                    lambda x=x, ln=ln, w=w, m=mask, g=gate, st=stats, r=residual: (
                        ffk.fused_ffn_block(x, *ln, *w, neuron_mask=m, gate=g, collect_stats=st,
                                            residual=r))))
        out.append(("fused_ffn", (x, *w, mask, stats),
                    lambda x=x, w=w, m=mask, st=stats: ffk.fused_ffn_plain(
                        x, *w, neuron_mask=m, collect_stats=st),
                    lambda x=x, w=w, m=mask, st=stats: ffk.fused_ffn(
                        x, *w, neuron_mask=m, collect_stats=st)))
    for lead, k, n in (((1,), 64, 48), ((13,), 96, 40), ((2, 3), 32, 72)):
        x = rn(*lead, k)
        w8, w4 = codes(k, n), tqm.pack_int4(codes(k, n, lo=-8, hi=8))
        sc = scale(n)
        out.append(("quant_matmul", (x, w8, sc),
                    lambda x=x, w=w8, sc=sc: tqm.quant_matmul_plain(x, w, sc),
                    lambda x=x, w=w8, sc=sc: tqm.quant_matmul(x, w, sc)))
        out.append(("quant4_matmul", (x, w4, sc),
                    lambda x=x, w=w4, sc=sc: tqm.quant4_matmul_plain(x, w, sc),
                    lambda x=x, w=w4, sc=sc: tqm.quant4_matmul(x, w, sc)))
    for lead, d, f in (((1,), 64, 80), ((9,), 32, 48), ((1, 3), 48, 40), ((19,), 16, 24)):
        x = rn(*lead, d)
        args = (x, codes(d, f), scale(f), codes(d, f), scale(f), codes(f, d), scale(d))
        out.append(("fused_mlp_int8", args,
                    lambda a=args: tfm.fused_mlp_int8_plain(*a),
                    lambda a=args: tfm.fused_mlp_int8(*a)))
    return out


def _flat(out):
    """Outputs as a list of tensors; the plain versions' absent stats (None)
    become the operators' empty fp32 stats."""
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [torch.empty(0) if t is None else t for t in outs]


def _meta(t):
    return (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_outputs_have_the_plain_versions_shapes_and_dtypes(dtype):
    cases = _cases("cpu", dtype)
    assert sorted({c[0] for c in cases}) == sorted(library.OPERATOR_NAMES)
    for name, args, plain, _ in cases:
        want = [_meta(t) for t in _flat(plain())]
        mode = FakeTensorMode()
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with mode:
            got = _flat(getattr(torch.ops.ssp, name)(*fake))
        assert [_meta(t) for t in got] == want, (name, [tuple(a.shape) for a in args
                                                        if isinstance(a, torch.Tensor)])
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
        assert [_meta(t) for t in _flat(getattr(torch.ops.ssp, name)(*meta))] == want, name


class _Ops(TorchDispatchMode):
    """Records the namespace of every operator dispatched while entered."""

    def __init__(self):
        super().__init__()
        self.namespaces = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.namespaces.add(func.namespace)
        return func(*args, **(kwargs or {}))


def test_cpu_wrapper_calls_never_reach_the_operators():
    """A CPU tensor takes the plain version: no ``ssp`` operator is dispatched
    and no launch is counted; the operators themselves refuse a CPU tensor
    (registered for CUDA only)."""
    reset_launch_counts()
    for name, args, plain, wrapper in _cases("cpu", torch.float32):
        with _Ops() as ops:
            got = _flat(wrapper())
        assert library.NAMESPACE not in ops.namespaces and "aten" in ops.namespaces, name
        for g, w in zip(got, _flat(plain())):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        with pytest.raises(NotImplementedError, match=f"ssp::{name}"):
            getattr(torch.ops.ssp, name)(*args)
    assert all(n == 0 for n in launch_counts.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest --noconftest -m cuda "
                    "tests/test_torch_custom_ops.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_pass_opcheck_on_the_card(cuda_device, dtype):
    """``torch.library.opcheck`` on every case of every operator; each call
    of the wrapper counts one launch."""
    for name, args, _, wrapper in _cases(cuda_device, dtype):
        torch.library.opcheck(getattr(torch.ops.ssp, name).default, args)
        before = launch_counts[name]
        wrapper()
        torch.cuda.synchronize()
        assert launch_counts[name] == before + 1, name
