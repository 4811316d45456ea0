"""Training-state checkpointing (counterpart of ``ssp_x_vit_tpu/utils``)."""
