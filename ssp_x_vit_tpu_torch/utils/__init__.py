"""Training-state checkpointing, seeding, tagged log lines and profiler traces
(counterpart of ``ssp_x_vit_tpu/utils``)."""
