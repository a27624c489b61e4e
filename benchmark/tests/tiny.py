"""Tiny configurations and traffic for the CPU tests: the cells' shapes
of computation at a size a test run can hold (head dim 64 as published,
two layers a tower, 64 x 48 views)."""

import copy

from benchmark.harness import Cell, load_cell

TINY_TOWERS = {"embed_dim": 128, "depth": 2, "num_heads": 2}
TINY_DECODER = {"enc_embed_dim": 128, "embed_dim": 128, "depth": 2,
                "num_heads": 2}
TINY_TRAFFIC = {
    "fused_bulk": {"img_hw": [48, 64], "n_views": 4, "n_scenes": 2,
                   "checked_among": 2},
    "keyframed": {"img_hw": [48, 64], "n_views": 7, "num_mem_images": 3,
                  "encode_bs": 2, "render_bs": 2, "checked_views": 3,
                  "checked_among": 2},
    "train_step": {"img_hw": [32, 32], "mem_batches": [2, 2],
                   "render_ids": [2, 3], "batch": 2, "capacity_block": 16,
                   "reference_samples": 1},
}


def tiny_cell(name: str, limits=None) -> Cell:
    """The cell ``name`` of BENCHMARK.json at the tiny size."""
    cell = copy.deepcopy(load_cell(name))
    cell.config["encoder"].update(TINY_TOWERS)
    cell.config["decoder"].update(TINY_DECODER)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    if limits is not None:
        cell.limits = limits
    return cell
