"""Training-state checkpointing and seeding (counterpart of ``ssp_x_vit_tpu/utils``)."""
