"""Each cell rehearsed on the CPU at the tiny size, the harness's look for
a card skipped: a sound run comes out correct; each control of
``controls.py`` (the reference one step lower in precision, or with a
fault, in the program's place) and each fault the cell can have, planted
in the program underneath the timed path, come out not correct; and no
module of JAX or of the JAX package was loaded."""

import numpy as np
import pytest
import torch

from benchmark import controls, harness
from benchmark.tests.tiny import tiny_cell
from benchmark.work import PEAK_FLOPS

SEED = 2 ** 31 + 1013
OFFLINE = ["offline512_bulk8x10", "offline512_kf50_r200",
           "offline512_kf50_r200_int8"]
TRAIN = ["train224_recipe_b16"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cell, driver_cls=None):
    return harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                            driver_cls=driver_cls, log=lambda *a: None)


@pytest.mark.parametrize("name", OFFLINE + TRAIN)
def test_sound_run_is_correct(name):
    result = run(tiny_cell(name))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert harness.forbidden_modules() == []


# -- the controls: the reference, one step lower or with a fault, in the
# program's place (benchmark/controls.py) --------------------------------

@pytest.mark.parametrize("name,ctl", [(n, c) for n in OFFLINE + TRAIN
                                      for c in controls.names(
                                          tiny_cell(n))])
def test_control_is_not_correct(name, ctl):
    cell = tiny_cell(name)
    result = run(cell, controls.control(cell, ctl))
    assert not result["correct"], result["checks"]


# -- faults planted in the program -----------------------------------------

def _no_write(monkeypatch):
    """A step that returns its state unchanged: no memory write lands."""
    from must3r_tpu_torch import memory
    monkeypatch.setattr(memory.MemoryState, "write_tokens",
                        lambda self, layer, start, new_kv: None)


def _alter_token(monkeypatch, module):
    """One token of the decoder's output altered where it is produced."""
    real = module.decoder_head

    def head(dec, cfg, tokens, *a, **k):
        tokens = tokens.clone()
        tokens[0, 0, 0] = -tokens[0, 0, 0]
        return real(dec, cfg, tokens, *a, **k)
    monkeypatch.setattr(module, "decoder_head", head)


def _half_scenes(monkeypatch, name):
    """Half of the batch left out: half of the collections (bulk) or of
    the views (keyframed) computed, the rest copied from them."""
    if name == "offline512_bulk8x10":
        from must3r_tpu_torch.engine import inference
        real = inference.make_fused_offline

        def make(core, n_views, img_hw, n_scenes=1, **k):
            run = real(core, n_views, img_hw, n_scenes=n_scenes // 2, **k)

            def half(imgs, portrait=None):
                out = run(imgs[:n_scenes // 2])
                return {key: torch.cat([v, v]) for key, v in out.items()}
            return half
        monkeypatch.setattr(inference, "make_fused_offline", make)
    else:
        from must3r_tpu_torch.demo import inference
        real = inference.must3r_inference

        def infer(core, views, **k):
            half = len(views) // 2 + 1
            s = real(core, views[:half], **{**k, "num_mem_images": min(
                k["num_mem_images"], half)})
            for f in ("pts3d", "pts3d_local", "conf", "focals",
                      "cams2world"):
                a = getattr(s, f)
                setattr(s, f, np.concatenate([a, a])[:len(views)])
            return s
        monkeypatch.setattr(inference, "must3r_inference", infer)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("name", OFFLINE)
def test_offline_fault_is_not_correct(name, fault, monkeypatch):
    if fault == "state_unchanged":
        _no_write(monkeypatch)
    elif fault == "half_batch":
        _half_scenes(monkeypatch, name)
    else:
        from must3r_tpu_torch.engine import inference
        _alter_token(monkeypatch, inference)
    result = run(tiny_cell(name))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered", "answer_altered"])
def test_train_fault_is_not_correct(fault, monkeypatch):
    from must3r_tpu_torch.engine import train
    if fault == "state_unchanged":
        monkeypatch.setattr(train, "apply_updates", lambda p, u: None)
    elif fault == "answer_altered":
        real_apply = train.apply_updates

        def doubled(params, updates):
            """The largest leaf's update doubled where it is produced."""
            k = max(updates, key=lambda n: float(updates[n].norm()))
            return real_apply(params, {**updates, k: 2 * updates[k]})
        monkeypatch.setattr(train, "apply_updates", doubled)
    elif fault == "half_batch":
        real = train.make_loss_fn

        def make(*a, **k):
            loss_fn = real(*a, **k)

            def half(params, batch, generator=None):
                b = batch["img"].shape[0] // 2
                return loss_fn(params, {key: (v if key == "render_ids"
                                              else v[:b])
                                        for key, v in batch.items()},
                               generator)
            return half
        monkeypatch.setattr(train, "make_loss_fn", make)
    else:
        _alter_token(monkeypatch, train)
    result = run(tiny_cell(TRAIN[0]))
    assert not result["correct"], result["checks"]


def test_traced_run_reads_host_metrics_from_the_untraced_window(
        monkeypatch):
    """With --trace 1 an untraced window comes first: the host-clock
    metrics (mfu) read it, the device-trace ones the traced window after
    it, and both windows' requests are attempted."""
    cell = tiny_cell("offline512_bulk8x10")
    windows = []
    real = harness.run_window

    def spy(*a, **k):
        windows.append(real(*a, **k))
        return windows[-1]
    monkeypatch.setattr(harness, "run_window", spy)
    result = harness.run_cell(cell, SEED, 0.2, True, device="cpu",
                              log=lambda *a: None)
    assert result["correct"], result["checks"]
    host, traced = windows
    assert result["attempted"] == host.requests + traced.requests
    work = harness.driver_class(cell)(cell.config, cell.traffic, SEED,
                                      torch.device("cpu")).work()
    assert result["metrics"]["mfu.offline"]["value"] == pytest.approx(
        100 * work.flops * host.requests / host.seconds / PEAK_FLOPS)
    assert result["device"]["window_s"] > 0
