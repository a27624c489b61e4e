"""A tiny VGGT cell for the CPU tests: the cell's computation at a size a
test run holds (head dim 64 as published, two tower blocks and two
aggregator iterations, a one-block camera trunk of head dim 128, DPT
features 32, three frames of 56 x 70)."""

import copy

from benchmark.harness import load_cell

CELL = "vggt1b_s64_518"
TINY = {
    "encoder": {"img_size": 70, "embed_dim": 128, "depth": 2, "num_heads": 2},
    "decoder": {"embed_dim": 128, "depth": 2, "num_heads": 2},
    "camera_head": {"dim": 256, "trunk_depth": 1, "num_heads": 2},
    "dpt_head": {"features": 32, "out_channels": [16, 32, 64, 64],
                 "layers": [0, 0, 1, 1], "frames_chunk": 2},
}
TINY_TRAFFIC = {"img_hw": [56, 70], "n_views": 3, "checked_among": 2}


def tiny_vggt_cell(name: str = CELL, limits=None):
    cell = copy.deepcopy(load_cell(name))
    for section, sizes in TINY.items():
        cell.config[section].update(sizes)
    cell.traffic.update(TINY_TRAFFIC)
    if limits is not None:
        cell.limits = limits
    return cell
