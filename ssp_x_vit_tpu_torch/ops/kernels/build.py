"""Build the CUDA sources in ``csrc/`` with nvcc at first use, bind them with
ctypes, and launch them (``layer_norm``, ``gemm``, ``attention``,
``flash_attention``, ``quant_gemm``, ``paged_attention``, ``paged_pool_write``,
``paged_attention_write``, ``paged_mla_attention``, ``paged_mla_hopper_write``;
``quant_fused_mlp`` is launched by ``ops/kernels/quant_fused_mlp.py``).

Each ``csrc/<name>.cu`` becomes ``build/kernels/<hash>/lib<name>.so`` at the
repository root, where ``<hash>`` covers every source and header and the nvcc
flags, so an edited source rebuilds and an unchanged one is reused. All
missing libraries are compiled in parallel, one nvcc process per source.
Nothing here runs at import time: this module imports on machines without
nvcc or a GPU, and only ``library()`` needs them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gemm", "attention", "flash_attention", "flash_attention_bwd", "quant_gemm",
           "paged_attention", "quant_fused_mlp", "paged_mla", "paged_mla_hopper")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Must match enum DType in csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Must match enum PoolType in csrc/paged_attention.cu, csrc/paged_mla.cu and
# csrc/paged_mla_hopper.cu.
POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "gemm": {
        "ssp_layer_norm": ([_I, _P, _P, _P, _P, _I, _I, _F, _P], _I),
        "ssp_gemm": ([_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P], _I),
        "ssp_gemm_workspace_floats": ([_I, _I, _I, _I], ctypes.c_longlong),
        "ssp_error_string": ([_I], ctypes.c_char_p),
    },
    "attention": {
        "ssp_attention": ([_I, _P, _P, _I, _I, _I, _I, _F, _P], _I),
        "ssp_attention_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
    },
    "flash_attention": {
        "ssp_flash_attention": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _F, _P, _I,
                                 _P], _I),
    },
    "flash_attention_bwd": {
        "ssp_flash_attention_bwd_dq": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _F, _I, _I, _F, _P], _I),
        "ssp_flash_attention_bwd_dkv": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _F, _I, _I, _F, _P], _I),
    },
    "quant_gemm": {
        "ssp_quant_gemm": ([_I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
        "ssp_quant_gemm_workspace_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    },
    "paged_attention": {
        "ssp_paged_attention": ([_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _L, _I, _F, _F, _I, _I, _P, _P, _P], _I),
        "ssp_paged_pool_write": ([_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _L, _I, _P], _I),
        "ssp_paged_attention_write": ([_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _L, _I, _F, _F, _I, _I, _P, _P,
                                       _P], _I),
    },
    "paged_mla": {
        "ssp_paged_mla_attention": ([_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _L, _I, _F, _I, _I, _P, _P, _P], _I),
    },
    "paged_mla_hopper": {
        "ssp_paged_mla_hopper_write": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I,
                                        _F, _I, _I, _P], _I),
        "ssp_paged_mla_hopper_clusters": ([_I, _I], _I),
    },
    "quant_fused_mlp": {
        "ssp_fused_mlp_int8": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                                _P], _I),
        "ssp_fused_mlp_int8_workspace_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
        "ssp_fused_mlp_int8_tickets": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    },
}

_libraries: Dict[str, ctypes.CDLL] = {}
_tickets: Dict[int, torch.Tensor] = {}
_workspaces: Dict[int, torch.Tensor] = {}
build_log: Dict[str, str] = {}  # nvcc output (ptxas register/smem report) per source
build_seconds: float = 0.0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are built "
                           "from ssp_x_vit_tpu_torch/ops/kernels/csrc at first use")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; return name -> .so path."""
    global build_seconds
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    missing = [name for name, so in targets.items() if not so.exists()]
    if missing:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs: List = []
        for name in missing:
            tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, targets[name])
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def not_traced(what: str) -> None:
    """Raise under a ``torch.export`` or ``torch.compile`` trace: a launch, a
    ticket buffer or a workspace made there would hold a traced tensor. Only
    the custom operators of ``ops/kernels/library.py`` reach the card from a
    traced program, inside their CUDA bodies, when it runs."""
    if torch.compiler.is_compiling():
        raise RuntimeError(f"{what} under a trace: this kernel is not a custom operator yet "
                           "(ops/kernels/library.py lists those that are)")


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` with its C signatures declared."""
    not_traced(f"the {name} kernel library")
    lib = _libraries.get(name)
    if lib is None:
        targets = build_all()
        for lib_name, so in targets.items():
            loaded = ctypes.CDLL(str(so))
            for fn, (argtypes, restype) in SIGNATURES[lib_name].items():
                getattr(loaded, fn).argtypes = argtypes
                getattr(loaded, fn).restype = restype
            _libraries[lib_name] = loaded
        lib = _libraries[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        name = library("gemm").ssp_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({name})")


EPI_BIAS, EPI_GELU, EPI_RESIDUAL = 0, 1, 2  # must match enum Epilogue in csrc/gemm.cu


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket counters on ``device``, all 0. A kernel that
    sums K or key splits inside its launch takes one ticket per output tile
    (the last split to arrive sums them all in order) and sets each counter
    back to 0, so one buffer per device serves every call in stream order."""
    not_traced("the ticket counters")
    buf = _tickets.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[device.index] = buf
    return buf


def workspace(device_index: int, n: int) -> torch.Tensor:
    """At least ``n`` fp32 of workspace on the card ``device_index``, one buffer per
    device: a kernel that combines its key runs inside the launch writes and
    reads it within that launch, so calls in stream order share it (as they
    share ``tickets``)."""
    not_traced("the workspace")
    buf = _workspaces.get(device_index)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1 << 16), dtype=torch.float32,
                          device=torch.device("cuda", device_index))
        _workspaces[device_index] = buf
    return buf


def raw_stream(device_index: int) -> int:
    """The current stream of the card ``device_index`` as a ``cudaStream_t``
    integer, without making a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """y = LN(x) over the last axis of a contiguous [m, n]-shaped tensor."""
    n = x.shape[-1]
    y = torch.empty_like(x)
    check(library("gemm").ssp_layer_norm(DTYPE_CODES[x.dtype], x.data_ptr(), g.data_ptr(),
                                         b.data_ptr(), y.data_ptr(), x.numel() // n, n, eps,
                                         _stream()), "ssp_layer_norm")
    return y


@functools.lru_cache(maxsize=None)
def _workspace_floats(device_index: int, dtype_code: int, m: int, n: int, k: int) -> int:
    # The split depends on the shape and the device's SM count only, so it is
    # asked of the library once per (device, shape).
    with torch.cuda.device(device_index):
        return library("gemm").ssp_gemm_workspace_floats(dtype_code, m, n, k)


def gemm(a: torch.Tensor, w: torch.Tensor, n_out: torch.Tensor, epi: int, *, bias=None,
         resid=None, gate=None, mask=None, stats=None, seq: int = 1) -> torch.Tensor:
    """c = epilogue(a[m, k] @ w[k, n]) into the preallocated ``n_out`` [m, n];
    allocates the split-K workspace when the GEMM's shape asks for one."""
    lib = library("gemm")
    k, n = w.shape
    m = a.numel() // k
    dt = DTYPE_CODES[a.dtype]
    ws_floats = _workspace_floats(a.device.index, dt, m, n, k)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=a.device) if ws_floats else None
    check(lib.ssp_gemm(dt, a.data_ptr(), w.data_ptr(), n_out.data_ptr(), m, n, k, epi,
                       _ptr(bias), _ptr(resid), _ptr(gate), _ptr(mask), _ptr(stats), seq,
                       _ptr(ws), _stream()), "ssp_gemm")
    return n_out


@functools.lru_cache(maxsize=None)
def attention_smem_bytes(dtype: torch.dtype, s: int, head_dim: int) -> int:
    return library("attention").ssp_attention_smem_bytes(DTYPE_CODES[dtype], s, head_dim)


def attention(qkv: torch.Tensor, out: torch.Tensor, b: int, s: int, heads: int,
              head_dim: int, scale: float) -> torch.Tensor:
    """out[b*s, d] = per-head softmax(q k^T * scale) v over the fused qkv [b*s, 3d]."""
    check(library("attention").ssp_attention(DTYPE_CODES[qkv.dtype], qkv.data_ptr(),
                                             out.data_ptr(), b, s, heads, head_dim, scale,
                                             _stream()), "ssp_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
                    scale: float, causal: bool, window: int, softcap: float,
                    lse: Optional[torch.Tensor] = None, q_offset: int = 0) -> torch.Tensor:
    """out[b, h, s, hd] = softmax(mask(softcap(q k^T * scale))) v for contiguous
    q [b, h, s, hd] and k, v [b, hkv, s, hd]; ``window`` and ``softcap`` <= 0 mean none.
    ``lse`` (fp32 [b, h, s]), when given, receives each row's log-sum-exp.
    ``q_offset`` (>= 0) puts query row r at key position r + q_offset in the masks."""
    b, h, s, hd = q.shape
    check(library("flash_attention").ssp_flash_attention(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
        k.shape[1], s, hd, scale, int(causal), window, softcap, _ptr(lse), int(q_offset),
        _stream()),
        "ssp_flash_attention")
    return out


def flash_attention_bwd_dq(q, k, v, o, dout, lse, delta, dq, *, scale: float, causal: bool,
                           window: int, softcap: float) -> torch.Tensor:
    """dq[b, h, s, hd] of the flash forward, and delta = rowsum(dout * o) (fp32
    [b, h, s]) for ``flash_attention_bwd_dkv``, from the forward's ``lse``."""
    b, h, s, hd = q.shape
    check(library("flash_attention_bwd").ssp_flash_attention_bwd_dq(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, k.shape[1], s,
        hd, scale, int(causal), window, softcap, _stream()), "ssp_flash_attention_bwd_dq")
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, *, scale: float, causal: bool,
                            window: int, softcap: float) -> None:
    """dk, dv [b, hkv, s, hd] of the flash forward (summed over each query group)
    from the forward's ``lse`` and the ``delta`` the dq kernel wrote."""
    b, h, s, hd = q.shape
    check(library("flash_attention_bwd").ssp_flash_attention_bwd_dkv(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], s, hd,
        scale, int(causal), window, softcap, _stream()), "ssp_flash_attention_bwd_dkv")


@functools.lru_cache(maxsize=None)
def _quant_workspace_floats(device_index: int, dtype_code: int, bits: int, m: int, n: int,
                            k: int) -> int:
    with torch.cuda.device(device_index):
        return library("quant_gemm").ssp_quant_gemm_workspace_floats(dtype_code, bits, m, n, k)


def quant_gemm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
               bits: int) -> torch.Tensor:
    """out[m, n] = (x[m, k] @ dequant(w)) * scale[n]; ``w`` is int8 [k, n]
    (bits 8) or split-half packed [k/2, n] (bits 4). Allocates the split-K
    workspace when the shape asks for one."""
    k = x.shape[-1]
    n = w.shape[-1]
    m = x.numel() // k
    dt = DTYPE_CODES[x.dtype]
    ws_floats = _quant_workspace_floats(x.device.index, dt, bits, m, n, k)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device) if ws_floats else None
    check(library("quant_gemm").ssp_quant_gemm(dt, bits, x.data_ptr(), w.data_ptr(),
                                               scale.data_ptr(), out.data_ptr(), m, n, k,
                                               _ptr(ws), _stream()), "ssp_quant_gemm")
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                    page_table: torch.Tensor, seq_lens: torch.Tensor,
                    start_lens: Optional[torch.Tensor], out: torch.Tensor, *, layer: int,
                    scale: float, softcap: float, pages_per_split: int, splits: int,
                    workspace: Optional[torch.Tensor], tickets: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """out[b, nq, hd] = decode attention of q [b, nq, hd] over layer ``layer`` of the 5D
    pools [A, nkv, P, ps, hd] (int8 pools with fp32 scales [A, nkv, P, ps]) through
    ``page_table`` [b, mp], keys ``start_lens <= pos < seq_lens``; ``softcap`` <= 0: none.
    The keys run in ``splits`` blocks of ``pages_per_split`` pages; more than one
    split takes the fp32 ``workspace`` and the zeroed int32 ``tickets`` of the plan."""
    b, nq, hd = q.shape
    _, nkv, num_pages, ps, _ = k_pool.shape
    check(library("paged_attention").ssp_paged_attention(
        DTYPE_CODES[q.dtype], POOL_CODES[k_pool.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
        seq_lens.data_ptr(), _ptr(start_lens), out.data_ptr(), b, nq, nkv, hd, ps,
        page_table.shape[1], num_pages, layer, scale, softcap, pages_per_split, splits,
        _ptr(workspace), _ptr(tickets), _stream()), "ssp_paged_attention")
    return out


def paged_pool_write(k_new: torch.Tensor, v_new: Optional[torch.Tensor], k_pool: torch.Tensor,
                     v_pool: Optional[torch.Tensor], k_scale: Optional[torch.Tensor],
                     v_scale: Optional[torch.Tensor], page_table: torch.Tensor,
                     positions: torch.Tensor, *, layer: int) -> None:
    """In place: row ``positions[i]`` of sequence i in layer ``layer`` of the 5D pools
    becomes ``k_new[i]`` / ``v_new[i]`` ([b, nkv, hd]; int8 pools quantize per token and
    KV head and take the fp32 scale pools). ``v_new`` None writes one pool only."""
    b, nkv, hd = k_new.shape
    _, _, num_pages, ps, _ = k_pool.shape
    check(library("paged_attention").ssp_paged_pool_write(
        DTYPE_CODES[k_new.dtype], POOL_CODES[k_pool.dtype], k_new.data_ptr(), _ptr(v_new),
        k_pool.data_ptr(), _ptr(v_pool), _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
        positions.data_ptr(), b, nkv, hd, ps, page_table.shape[1], num_pages, layer, _stream()),
        "ssp_paged_pool_write")


def paged_attention_write(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                          k_pool: torch.Tensor, v_pool: torch.Tensor,
                          k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                          page_table: torch.Tensor, positions: torch.Tensor,
                          start_lens: Optional[torch.Tensor], out: torch.Tensor, dims: tuple, *,
                          layer: int, workspace: Optional[torch.Tensor],
                          tickets: Optional[torch.Tensor], stream: int) -> torch.Tensor:
    """Write-and-attend in one launch: row ``positions[i]`` of sequence i in layer
    ``layer`` of the pools becomes ``k_new[i]`` / ``v_new[i]`` (as ``paged_pool_write``),
    and ``out`` the attention of ``q`` over the keys ``start_lens <= pos <=
    positions`` (as ``paged_attention``). ``dims``: (q dtype code, pool code, new-row
    dtype code, b, nq, nkv, hd, ps, mp, num_pages, scale, softcap, pages per split,
    splits), decided once per signature by the caller."""
    qc, pc, nc, b, nq, nkv, hd, ps, mp, num_pages, scale, softcap, pps, splits = dims
    check(library("paged_attention").ssp_paged_attention_write(
        qc, pc, nc, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
        positions.data_ptr(), _ptr(start_lens), out.data_ptr(), b, nq, nkv, hd, ps, mp,
        num_pages, layer, scale, softcap, pps, splits, _ptr(workspace), _ptr(tickets), stream),
        "ssp_paged_attention_write")
    return out


def paged_mla_attention(q: torch.Tensor, pool: torch.Tensor, scales: Optional[torch.Tensor],
                        page_table: torch.Tensor, lens: torch.Tensor,
                        new_row: Optional[torch.Tensor], out: torch.Tensor, *, layer: int,
                        scale: float, pages_per_split: int, splits: int,
                        workspace: Optional[torch.Tensor], tickets: Optional[torch.Tensor],
                        stream: Optional[int] = None) -> torch.Tensor:
    """out[b, nq, v_cols] = the first v_cols columns of the decode attention of q [b, nq,
    D] over layer ``layer`` of the MLA pool [A, 1, P, ps, D] (int8 pools with fp32
    ``scales`` [A, 1, P, ps]), the pool both keys and values, through ``page_table``
    [b, mp]: keys ``pos < lens``, or, with ``new_row`` [b, 1, D], row ``lens[i]`` (the
    positions) written first and keys ``pos <= lens``. The keys run in ``splits`` runs
    of ``pages_per_split`` pages; more than one run takes the fp32 ``workspace`` and the
    zeroed int32 ``tickets`` of the plan."""
    b, nq, D = q.shape
    _, _, num_pages, ps, _ = pool.shape
    check(library("paged_mla").ssp_paged_mla_attention(
        DTYPE_CODES[q.dtype], POOL_CODES[pool.dtype], q.data_ptr(), pool.data_ptr(),
        _ptr(scales), page_table.data_ptr(), lens.data_ptr(), _ptr(new_row), out.data_ptr(), b,
        nq, D, out.shape[2], ps, page_table.shape[1], num_pages, layer, scale, pages_per_split,
        splits, _ptr(workspace), _ptr(tickets), _stream() if stream is None else stream),
        "ssp_paged_mla_attention")
    return out


def paged_mla_hopper_clusters(pool_dtype: torch.dtype, size: int) -> int:
    """The most clusters of ``size`` CTAs of the Hopper MLA kernel for pools of
    ``pool_dtype`` that the current card holds at once."""
    n = library("paged_mla_hopper").ssp_paged_mla_hopper_clusters(POOL_CODES[pool_dtype], size)
    if n <= 0:
        raise RuntimeError(f"ssp_paged_mla_hopper_clusters: no cluster of {size} fits")
    return n


def paged_mla_hopper_write(q: torch.Tensor, new_row: torch.Tensor, pool: torch.Tensor,
                           scales: Optional[torch.Tensor], page_table: torch.Tensor,
                           positions: torch.Tensor, out: torch.Tensor, *, layer: int,
                           scale: float, pages_per_split: int, splits: int,
                           stream: int) -> torch.Tensor:
    """The MLA decode layer in one launch of ``csrc/paged_mla_hopper.cu``: ``new_row`` [b,
    1, 576] into slot ``positions[i]`` of layer ``layer`` of the pool [A, 1, P, ps, 576]
    (bf16, or int8 codes with fp32 ``scales`` [A, 1, P, ps]), then out [b, nq, 512] = the
    first 512 columns of the attention of q [b, nq, 576] over keys ``pos <= positions``,
    in ``splits`` runs (at most 8: one cluster) of ``pages_per_split`` pages."""
    b, nq, _ = q.shape
    layers, _, num_pages, ps, _ = pool.shape
    check(library("paged_mla_hopper").ssp_paged_mla_hopper_write(
        POOL_CODES[pool.dtype], q.data_ptr(), new_row.data_ptr(), pool.data_ptr(), _ptr(scales),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(), b, nq, ps,
        page_table.shape[1], num_pages, layers, layer, scale, pages_per_split, splits, stream),
        "ssp_paged_mla_hopper_write")
    return out
