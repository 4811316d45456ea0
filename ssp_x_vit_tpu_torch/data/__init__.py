from ssp_x_vit_tpu_torch.data.pipeline import (
    DataPipeline, load_cifar, load_procgen_slice, preprocess_batch, synthetic_dataset,
)

__all__ = ["DataPipeline", "load_cifar", "load_procgen_slice", "preprocess_batch",
           "synthetic_dataset"]
