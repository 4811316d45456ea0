"""Consensus-ensembling grid (reference manual-experiments/run_consensus_grid.py):
combo sizes 2-4, prune 5..70 step 5."""

from ssp_x_vit_tpu_torch.cli.grid import grid_main

if __name__ == "__main__":
    grid_main("consensus")
