"""The host <-> device route of ``demo.inference.must3r_inference`` and the
pinned-memory helpers of ``ops/transfer.py``.

``must3r_inference`` stages the views onto the core's device once, puts
them in processing order there, renders in input order (``to_render``),
denormalises the images there and fetches every output at once. The route
of the bytes changes, not the arithmetic: on the tiny fixture net the scene
equals, bit for bit, the one of the host route it replaced (rebuilt here:
numpy stack, host gather, fetch, host ``[inv]``, ``denormalize_image``),
for ordered and retrieval keyframes, with and without a portrait view; on
the CPU in fp32 and, marked ``cuda``, on the card in bf16. The card tests
of ``fetch`` / ``stage_in`` check the values, the pinned memory, the byte
counter and that a second fetch of the same sizes pins nothing new.

This file imports no jax, so on a GPU machine without jax it runs on its
own (the repo's conftest imports jax):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_inference_io.py -q
"""

import os

import numpy as np
import pytest
import torch

from must3r_tpu_torch.checkpoint import (load_model, load_params_npz,
                                         params_from_jax)
from must3r_tpu_torch.demo.inference import (SceneState, must3r_inference,
                                             select_keyframes)
from must3r_tpu_torch.engine.inference import (InferenceCore,
                                               offline_reconstruction,
                                               view_positions)
from must3r_tpu_torch.ops import transfer
from must3r_tpu_torch.tools.image import (denormalize_image,
                                          denormalize_images, normalize_image)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "demo_tiny_params.npz")
FIELDS = ("pts3d", "pts3d_local", "conf", "imgs", "true_shape", "focals",
          "cams2world")
# 10 views, batches of 4: the render batches (and the padding of the last)
# differ between processing order and input order
KW = dict(num_mem_images=4, encode_bs=4, render_bs=4)


def _core(device, dtype):
    params, enc_cfg, dec_cfg = load_params_npz(FIXTURE)
    enc, dec = load_model(*params_from_jax(params, enc_cfg, dec_cfg),
                          enc_cfg, dec_cfg, device=device)
    return InferenceCore(enc, dec, enc_cfg, dec_cfg, dtype=dtype)


@pytest.fixture(scope="module")
def cpu_core():
    return _core("cpu", torch.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


def views_of(seed, n=10, hw=(48, 64), portrait=()):
    """n normalised views stored landscape: random values a little past
    [-1, 1] (the clip on both sides), every third one an image of uint8
    pixels as ``normalize_image`` makes it (denormalisation's truncation at
    whole values); views in ``portrait`` are stored transposed."""
    rng = np.random.default_rng(seed)
    views = []
    for i in range(n):
        if i % 3 == 0:
            img = normalize_image(rng.integers(0, 256, (*hw, 3), np.uint8))
        else:
            img = rng.uniform(-1.1, 1.1, (*hw, 3)).astype(np.float32)
        views.append({"img": img, "portrait": i in portrait,
                      "true_shape": np.asarray(hw[::-1] if i in portrait
                                               else hw),
                      "path": f"v{i}"})
    return views


def host_route(core, views, is_sequence, num_mem_images, encode_bs,
               render_bs):
    """``must3r_inference`` as the host route had it: the views stacked in
    numpy, gathered into processing order on the host, rendered in that
    order, fetched, put back in input order by a numpy ``[inv]``, the
    images denormalised view by view on the host."""
    v = len(views)
    imgs = torch.from_numpy(np.stack([vw["img"] for vw in views]))
    portrait = torch.tensor([bool(vw.get("portrait")) for vw in views])
    img_hw = tuple(imgs.shape[1:3])
    if is_sequence:
        keyframes = np.linspace(0, v - 1,
                                num_mem_images).astype(int).tolist()
    else:
        pos = view_positions(img_hw, core.enc_cfg.patch_size,
                             portrait.to(core.device), batch_shape=(v,),
                             device=core.device)
        x = core.encode_all(imgs.to(core.device), pos, max_bs=encode_bs)
        keyframes = select_keyframes(core, x, num_mem_images)
    keyframes = list(dict.fromkeys(int(k) for k in keyframes))
    order = keyframes + sorted(set(range(v)) - set(keyframes))
    out = offline_reconstruction(
        core, imgs[order], img_hw=img_hw, portrait=portrait[order],
        mem_views=list(range(len(keyframes))), render_bs=render_bs,
        encode_bs=encode_bs, compute_cam=True)
    inv = np.argsort(np.asarray(order))
    out = {k: t.float().cpu().numpy()[inv] for k, t in out.items()}
    return SceneState(
        pts3d=out["pts3d"], pts3d_local=out["pts3d_local"], conf=out["conf"],
        imgs=np.stack([denormalize_image(np.asarray(vw["img"]))
                       for vw in views]),
        true_shape=np.asarray([vw["true_shape"] for vw in views]),
        focals=out["focal"], cams2world=out["c2w"],
        image_list=[vw.get("path", str(i)) for i, vw in enumerate(views)])


def assert_same_scene(got, want):
    assert got.image_list == want.image_list
    for key in FIELDS:
        g, w = getattr(got, key), getattr(want, key)
        assert isinstance(g, np.ndarray), key
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


CASES = [(True, ()), (False, ()), (True, (1, 6)), (False, (1, 6))]
CASE_IDS = ["sequence", "retrieval", "sequence-portrait",
            "retrieval-portrait"]


@pytest.mark.parametrize("is_sequence,portrait", CASES, ids=CASE_IDS)
def test_must3r_inference_equals_host_route(cpu_core, is_sequence,
                                            portrait):
    views = views_of(3, portrait=portrait)
    want = host_route(cpu_core, views, is_sequence, **KW)
    got = must3r_inference(cpu_core, views, is_sequence=is_sequence, **KW)
    assert_same_scene(got, want)
    assert want.imgs.dtype == np.uint8 and want.pts3d.dtype == np.float32


def test_denormalize_images_is_bitwise_the_numpy_one():
    """Every normalised uint8 value (about a quarter truncate one below
    their pixel, in both) and values past both ends of the clip."""
    rng = np.random.default_rng(0)
    grid = normalize_image(np.arange(256, dtype=np.uint8)[None, :, None]
                           .repeat(3, 2))
    imgs = np.concatenate([grid.reshape(-1, 3),
                           rng.uniform(-1.5, 1.5, (4096, 3))
                           .astype(np.float32)])
    got = denormalize_images(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, denormalize_image(imgs))


def test_stage_in_and_fetch_on_the_cpu_keep_the_host_route():
    arrays = [np.full((2, 3), i, np.float32) for i in range(4)]
    transfer.reset_moved_bytes()
    t = transfer.stage_in(arrays, "cpu")
    np.testing.assert_array_equal(t.numpy(), np.stack(arrays))
    out = transfer.fetch({"a": t, "b": t[:, 0].to(torch.uint8)})
    assert np.shares_memory(out["a"], t.numpy())
    assert out["b"].dtype == np.uint8
    # nothing went through pinned memory
    assert transfer.moved_bytes() == {"to_device": 0, "to_host": 0}


@pytest.mark.cuda
def test_fetch_on_card_is_pinned_counted_and_reuses_its_blocks(dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def outputs():
        return {"pts3d": torch.randn(6, 48, 64, 3, generator=gen,
                                     device=dev),
                "conf": torch.rand(6, 48, 64, generator=gen, device=dev),
                "imgs": torch.randint(0, 256, (6, 48, 64, 3), generator=gen,
                                      device=dev, dtype=torch.uint8),
                "c2w": torch.randn(6, 4, 4, generator=gen, device=dev)
                .double()}

    ts = outputs()
    transfer.reset_moved_bytes()
    got = transfer.fetch(ts)
    assert set(got) == set(ts)
    for k, t in ts.items():
        assert isinstance(got[k], np.ndarray) and got[k].dtype == \
            t.cpu().numpy().dtype, k
        np.testing.assert_array_equal(got[k], t.cpu().numpy(), err_msg=k)
        assert torch.from_numpy(got[k]).is_pinned(), k
    assert transfer.moved_bytes() == {
        "to_device": 0, "to_host": sum(t.nbytes for t in ts.values())}
    del got
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    again = transfer.fetch(outputs())
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
    assert all(torch.from_numpy(a).is_pinned() for a in again.values())


@pytest.mark.cuda
def test_stage_in_on_card_uploads_and_counts(dev):
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((48, 64, 3)).astype(np.float32)
              for _ in range(5)]
    transfer.reset_moved_bytes()
    t = transfer.stage_in(arrays, dev)
    assert t.device.type == "cuda" and t.dtype == torch.float32
    np.testing.assert_array_equal(t.cpu().numpy(), np.stack(arrays))
    assert transfer.moved_bytes() == {"to_device": t.nbytes, "to_host": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("is_sequence", [True, False],
                         ids=["sequence", "retrieval"])
def test_must3r_inference_on_card_equals_host_route(dev, is_sequence):
    core = _core(dev, torch.bfloat16)
    views = views_of(4, portrait=(2,))
    want = host_route(core, views, is_sequence, **KW)
    got = must3r_inference(core, views, is_sequence=is_sequence, **KW)
    assert_same_scene(got, want)
    assert torch.from_numpy(got.pts3d).is_pinned()
