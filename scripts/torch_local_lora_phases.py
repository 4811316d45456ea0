#!/usr/bin/env python3
"""``chip_smoke.py``'s local-corpus and multi-LoRA phases alone on one card.

    python3 scripts/torch_local_lora_phases.py

Builds every kernel, then runs ``phase_corpus`` (``[CORPUS]``: the committed
``corpus_slice`` decoded, written as ``save_to_disk`` directories by
``scripts/arrow_corpus.py`` and read back), ``phase_local`` (``[LOCAL]``:
``main_llm --local_datasets`` 25% 2SSP at Llama-2-7B widths cut to 4 layers),
``phase_train_data`` (``[TRAIN]``: ``train_llm --data`` at Llama-2-7B width
and depth), ``phase_lora`` (``[LORA]``: multi-LoRA ``generate_kv_scan`` on the
Llama-2-7B-width int8 tree), a ``DataPipeline`` of 224 x 224 synthetic images
through the native ``gather_batch`` (``watch_gather``), and the two
``code_llm_small`` anchors (card against the host CPU). Seconds per phase.
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.data.pipeline import DataPipeline, synthetic_dataset
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int8
    from ssp_x_vit_tpu_torch.ops.kernels import build

    device = torch.device("cuda", 0)
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    seconds = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            corpora = cs.phase_corpus(work)
            seconds["corpus"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cs.phase_local(device, work)
            seconds["local"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cs.phase_train_data(work, corpora)
            seconds["train --data"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, cfg = cs.make_llama_7b(device)
    q8 = quantize_llm_params_int8(params, cfg)
    cs.phase_lora(device, params, q8, cfg)
    del params, q8
    torch.cuda.empty_cache()
    seconds["lora"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    watch = cs.watch_gather()
    images, labels = synthetic_dataset(256, 10, image_size=224, seed=3)
    batches = DataPipeline(images, labels, img_size=224, batch_size=64, shuffle=True, flip=True,
                           device=device).batches()
    calls, n = watch.stop()
    cs.log(f"[MAIN] DataPipeline 224 x 224, b=64: {calls} batches ({n} images) through the native "
           f"gather_batch, bit for bit the numpy gather's; {len(batches)} batches on the card")
    if calls != len(batches) or calls == 0:
        raise AssertionError("the pipeline's batches did not all go through gather_batch")
    seconds["gather"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            cs.phase_anchor_local(device, work)
            seconds["anchor local"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    t0 = time.perf_counter()
    cs.phase_anchor_lora_serving(device)
    seconds["anchor lora"] = time.perf_counter() - t0
    cs.log(f"[PHASES] seconds {({k: round(v, 1) for k, v in seconds.items()})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
