"""Summation-ensembling grid (reference manual-experiments/run_summation_grid.py):
combo sizes 1-4, prune 5..50 step 5."""

from ssp_x_vit_tpu_torch.cli.grid import grid_main

if __name__ == "__main__":
    grid_main("summation")
