"""The plain reference against the program at a tiny size on the CPU, both
in float32: the same weights and inputs give the same outputs, losses and
gradients. (The test imports both; the reference imports nothing of the
program.)"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.compare import rel_gap
from benchmark.program import load_program_model
from benchmark.reference import must3r as ref
from benchmark.reference import train as ref_train
from benchmark.tests.tiny import tiny_cell
from benchmark.weights import make_weights

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_reference_imports_nothing_of_the_program():
    for path in (Path(ref.__file__), Path(ref_train.__file__)):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert tops <= {"__future__", "math", "dataclasses", "typing",
                        "torch", "benchmark"}, tops
        assert not any(n.startswith("benchmark.") and not
                       n.startswith("benchmark.reference") for n in names)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_offline_matches_the_program(kv_quant):
    from must3r_tpu_torch.engine.inference import (InferenceCore,
                                                   make_fused_offline)
    cell = tiny_cell("offline512_bulk8x10")
    cfg = cell.config
    enc, dec, ec, dc = load_program_model(cfg, SEED, "cpu")
    core = InferenceCore(enc, dec, ec, dc, dtype=torch.float32,
                         kv_quant=kv_quant)
    s, v, hw = 2, 5, (48, 64)
    imgs = torch.rand(s, v, *hw, 3, generator=torch.Generator().manual_seed(
        3)) * 2 - 1
    out = make_fused_offline(core, v, hw, n_scenes=s)(imgs)
    weights = make_weights(cfg, SEED, "cpu")
    nm = ref.Numerics(memory_qmax=None if kv_quant is None else 127.0)
    # an 8-bit code may round the other way on a float32 difference of
    # 1e-7 at a half step: a few such codes move the outputs by ~1e-4
    tol = 2e-5 if kv_quant is None else 2e-3
    for i in range(s):
        r = ref.reconstruct(weights, cfg, imgs[i], n_mem=v, nm=nm)
        for k in ("pts3d", "pts3d_local", "conf"):
            assert rel_gap(out[k][i].numpy(), r[k]) < tol, k
        # the camera stage on the program's own pointmaps (the pose of
        # random pointmaps amplifies their differences tenfold)
        focal, c2w = ref.camera(out["pts3d"][i], out["pts3d_local"][i],
                                out["conf"][i])
        assert rel_gap(out["c2w"][i].numpy(), c2w) < 1e-5
        np.testing.assert_allclose(out["focal"][i].numpy(), focal.numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_training_matches_the_program():
    from must3r_tpu_torch.engine.train import (TrainSettings,
                                               make_loss_fn, trainable_subset)
    cell = tiny_cell("train224_recipe_b16")
    cfg, t = cell.config, cell.traffic
    enc, dec, ec, dc = load_program_model(cfg, SEED, "cpu", causal=True)
    ts = TrainSettings(mem_batches=tuple(t["mem_batches"]),
                       n_render=len(t["render_ids"]),
                       dropout_p=t["dropout_p"],
                       capacity_block=t["capacity_block"], dtype="float32")
    params = {"encoder": enc, "decoder": dec}
    train = trainable_subset(params, ts)
    for p in train.values():
        p.requires_grad_(True)
    from benchmark.drivers.train_step import train_batch
    gen = torch.Generator().manual_seed(5)
    batch = train_batch(gen, "cpu", t["batch"], sum(t["mem_batches"]),
                        t["img_hw"], 16, t["render_ids"])
    loss_fn = make_loss_fn(ec, dc, ts)
    drop = torch.Generator().manual_seed(9)
    loss, _ = loss_fn(params, batch, drop)
    grads = torch.autograd.grad(loss, list(train.values()))
    n_tok = (t["img_hw"][0] // 16) * (t["img_hw"][1] // 16)
    block = t["capacity_block"]
    cap = -(-sum(t["mem_batches"]) * n_tok // block) * block
    drop = torch.Generator().manual_seed(9)
    draws = [torch.rand((t["batch"], g, cap), generator=drop) < t["dropout_p"]
             for g in t["mem_batches"]]
    weights = make_weights(cfg, SEED, "cpu")
    for k, w in weights.items():
        w.requires_grad_(k.startswith("decoder."))
    recipe = {"mem_batches": t["mem_batches"], "render_ids": t["render_ids"],
              "protected_imgs": 1, "alpha": t["alpha"],
              "sky_loss_value": t["sky_loss_value"]}
    r_loss, r_grads = ref_train.loss_and_grads(weights, cfg, batch, draws,
                                               recipe, samples=1)
    assert float(loss) == pytest.approx(r_loss, rel=1e-5)
    for (k, p), g in zip(train.items(), grads):
        r = r_grads[k]
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()) + 1e-7, k
