"""Typed model configuration of the port: its own copy of
``must3r_tpu/config.py``, so that the port imports nothing of the JAX
package.

Frozen dataclasses (hashable, JSON round-trip for self-describing
checkpoints) replace the reference's ``eval()``'d constructor strings; a
shim (``*_from_arg_string``) still parses those strings (e.g.
``"MUSt3R(img_size=(512,512), memory_mode='kv')"``) so reference
checkpoints and CLI flags keep working.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple


class ActivationType(str, Enum):
    """Pointmap output activation (reference: must3r/model/blocks/head.py:8-21)."""

    NORM_EXP = "norm_exp"
    LINEAR = "linear"


class MemoryMode(str, Enum):
    """What the per-layer token memory stores (reference: blocks/layers.py:81-88).

    * KV:     precomputed (k, v) through the cross-attention projections --
              the natural KV-cache form; per-query cost is a pure read.
    * NORM_Y: LayerNorm'ed tokens; k/v projections run at read time.
    * RAW:    raw tokens; LayerNorm + k/v projections run at read time.
    """

    KV = "kv"
    NORM_Y = "norm_y"
    RAW = "raw"


class FeedbackType(str, Enum):
    """Cross-layer memory coupling (reference: feedback_mechanism.py:11-23)."""

    NONE = "none"
    SINGLE_MLP = "single_mlp"
    SINGLE_LINEAR = "single_linear"


@dataclass(frozen=True)
class RoPEConfig:
    """2D rotary embedding config.

    ``base`` is the frequency base (reference ``'RoPE100'`` -> base=100).
    ``f0`` rescales positions for resolution transfer: a model trained at
    ``old`` and run at ``new`` uses ``f0 = old / new`` so frequencies behave
    in [0, new] like they did in [0, old]
    (reference: must3r/model/blocks/pos_embed.py:7-22).
    """

    base: float = 100.0
    f0: float = 1.0

    @staticmethod
    def parse(spec: str) -> "RoPEConfig":
        """Parse ``'RoPE100'`` or adaptive ``'RoPE100_224:512'`` strings."""
        assert spec.startswith("RoPE"), spec
        f0 = 1.0
        if "_" in spec:
            spec, res = spec.split("_")
            old, new = res.split(":")
            f0 = float(old) / float(new)
        return RoPEConfig(base=float(spec[len("RoPE"):]), f0=f0)

    def spec_string(self, old: Optional[int] = None, new: Optional[int] = None) -> str:
        base = f"RoPE{self.base:g}"
        if old is not None and new is not None and old != new:
            return f"{base}_{old}:{new}"
        return base


@dataclass(frozen=True)
class EncoderConfig:
    """CroCo/DUSt3R-style ViT encoder (reference: must3r/model/encoder.py:14-44)."""

    img_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    rope: RoPEConfig = RoPEConfig()

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclass(frozen=True)
class DecoderConfig:
    """MUSt3R memory decoder (reference: must3r/model/decoder.py:19-46).

    ``causal`` selects training semantics (the reference's ``CausalMUSt3R``):
    multi-image blocks with a per-image label-causal attention mask. At
    inference the same weights run non-causally (``MUSt3R``).
    """

    img_size: Tuple[int, int] = (224, 224)
    enc_embed_dim: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    output_dim: int = 1792  # 16*16*7
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    rope: RoPEConfig = RoPEConfig()
    landscape_only: bool = False
    head: str = "Linear"
    feedback: FeedbackType = FeedbackType.NONE
    memory_mode: MemoryMode = MemoryMode.NORM_Y
    pointmaps_activation: ActivationType = ActivationType.NORM_EXP
    # training-only knobs (reference: decoder.py:358-377)
    causal: bool = False
    protected_imgs: int = 1
    mem_dropout: float = 0.0
    dropout_mode: str = "temporary"  # 'temporary' | 'permanent'

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def n_output_channels(self) -> int:
        return self.output_dim // (self.patch_size * self.patch_size)

    def with_memory_mode(self, mode: MemoryMode) -> "DecoderConfig":
        return dataclasses.replace(self, memory_mode=mode)

    def inference_variant(self) -> "DecoderConfig":
        """CausalMUSt3R -> MUSt3R, landscape_only=False
        (reference: model/__init__.py:53-63)."""
        return dataclasses.replace(self, causal=False, landscape_only=False,
                                   mem_dropout=0.0)


# ---------------------------------------------------------------------------
# Flagship model presets (reference checkpoints, README.md:107-112)
# ---------------------------------------------------------------------------

def must3r_512_configs() -> Tuple[EncoderConfig, DecoderConfig]:
    """MUSt3R_512: ViT-L encoder (24 x 1024 x 16h) + ViT-B decoder
    (12 x 768 x 12h), linear head, feedback MLP, 512-bucket resolutions."""
    enc = EncoderConfig(img_size=(512, 512), patch_size=16, embed_dim=1024,
                        depth=24, num_heads=16, mlp_ratio=4.0)
    dec = DecoderConfig(img_size=(512, 512), enc_embed_dim=1024,
                        patch_size=16, embed_dim=768, output_dim=1792,
                        depth=12, num_heads=12, mlp_ratio=4.0,
                        feedback=FeedbackType.SINGLE_MLP,
                        memory_mode=MemoryMode.KV)
    return enc, dec


def must3r_224_configs() -> Tuple[EncoderConfig, DecoderConfig]:
    """MUSt3R_224_cvpr: same towers at 224x224."""
    enc = EncoderConfig(img_size=(224, 224), patch_size=16, embed_dim=1024,
                        depth=24, num_heads=16, mlp_ratio=4.0)
    dec = DecoderConfig(img_size=(224, 224), enc_embed_dim=1024,
                        patch_size=16, embed_dim=768, output_dim=1792,
                        depth=12, num_heads=12, mlp_ratio=4.0,
                        feedback=FeedbackType.SINGLE_MLP,
                        memory_mode=MemoryMode.KV)
    return enc, dec


@dataclass(frozen=True)
class VGGTConfig:
    """VGGT (Wang et al., CVPR 2025; github.com/facebookresearch/vggt): a
    DINOv2 ViT tower with register tokens, an aggregator of alternating
    frame and global attention blocks (QK-LayerNorm, LayerScale, 2D RoPE,
    camera and register tokens of their own for the first frame), a camera
    head refining a 9-number pose encoding under adaLN modulation, and two
    DPT heads (depth, world points). The track head is not part of it.

    ``img_size``: the square the tower's position embedding was learned at
    (its grid is ``img_size // patch_size`` a side, resized to the frame's
    patch grid). ``dpt_layers``: the aggregator iterations the DPT heads
    read (the camera head reads the last)."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    tower_depth: int = 24
    num_register_tokens: int = 4
    tower_ln_eps: float = 1e-6
    depth: int = 24
    ln_eps: float = 1e-5
    rope: RoPEConfig = RoPEConfig(base=100.0)
    camera_trunk_depth: int = 4
    camera_num_heads: int = 16
    camera_iterations: int = 4
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    dpt_layers: Tuple[int, int, int, int] = (4, 11, 17, 23)
    dpt_frames_chunk: int = 8

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def n_special(self) -> int:
        """Camera and register tokens at the front of each frame."""
        return 1 + self.num_register_tokens

    @property
    def camera_dim(self) -> int:
        return 2 * self.embed_dim


def vggt_1b_config() -> VGGTConfig:
    """VGGT-1B as published (facebook/VGGT-1B): a ViT-L/14 tower with 4
    registers, 24 frame + 24 global blocks of 1024 x 16 heads, a 4-block
    2048-wide camera trunk run 4 times, DPT heads of 256 features."""
    return VGGTConfig()


# ---------------------------------------------------------------------------
# Reference arg-string compatibility shim
# ---------------------------------------------------------------------------

_ENC_NAMES = ("Dust3rEncoder",)
_DEC_NAMES = ("CausalMUSt3R", "MUSt3R")


def _parse_call(s: str):
    """Parse ``Name(k=v, ...)`` into (name, kwargs) without eval()."""
    s = s.strip()
    m = re.match(r"^(\w+)\((.*)\)$", s, re.DOTALL)
    if not m:
        raise ValueError(f"cannot parse constructor string: {s!r}")
    name, argstr = m.group(1), m.group(2)
    kwargs = {}
    if argstr.strip():
        tree = ast.parse(f"f({argstr})", mode="eval")
        call = tree.body
        if call.args:
            raise ValueError(f"positional args unsupported in {s!r}")
        for kw in call.keywords:
            kwargs[kw.arg] = ast.literal_eval(kw.value)
    return name, kwargs


def encoder_config_from_arg_string(s: str) -> EncoderConfig:
    """Parse a reference encoder constructor string, e.g.
    ``"Dust3rEncoder(img_size=(512, 512), pos_embed='RoPE100')"``."""
    name, kw = _parse_call(s)
    assert name in _ENC_NAMES, name
    img_size = kw.get("img_size", (224, 224))
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    return EncoderConfig(
        img_size=tuple(img_size),
        patch_size=kw.get("patch_size", 16),
        embed_dim=kw.get("embed_dim", 1024),
        depth=kw.get("depth", 24),
        num_heads=kw.get("num_heads", 16),
        mlp_ratio=float(kw.get("mlp_ratio", 4)),
        rope=RoPEConfig.parse(kw.get("pos_embed", "RoPE100")),
    )


def decoder_config_from_arg_string(s: str) -> DecoderConfig:
    """Parse a reference decoder constructor string, e.g.
    ``"CausalMUSt3R(img_size=(512,512), memory_mode='kv',
    feedback_type='single_mlp')"``."""
    name, kw = _parse_call(s)
    assert name in _DEC_NAMES, name
    img_size = kw.get("img_size", (224, 224))
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    fb = kw.get("feedback_type", None)
    return DecoderConfig(
        img_size=tuple(img_size),
        enc_embed_dim=kw.get("enc_embed_dim", 1024),
        patch_size=kw.get("patch_size", 16),
        embed_dim=kw.get("embed_dim", 768),
        output_dim=kw.get("output_dim", 1792),
        depth=kw.get("depth", 12),
        num_heads=kw.get("num_heads", 12),
        mlp_ratio=float(kw.get("mlp_ratio", 4)),
        rope=RoPEConfig.parse(kw.get("pos_embed", "RoPE100")),
        landscape_only=kw.get("landscape_only", True),
        feedback=FeedbackType(fb) if fb else FeedbackType.NONE,
        memory_mode=MemoryMode(kw.get("memory_mode", "norm_y")),
        pointmaps_activation=ActivationType(kw.get("pointmaps_activation", "norm_exp")),
        causal=(name == "CausalMUSt3R"),
        protected_imgs=kw.get("protected_imgs", 1),
        mem_dropout=kw.get("mem_dropout", 0.0),
        dropout_mode=kw.get("dropout_mode", "temporary"),
    )


def encoder_config_to_arg_string(cfg: EncoderConfig) -> str:
    """Inverse of :func:`encoder_config_from_arg_string` -- emits the
    reference constructor string stored in `.pth` checkpoints
    (reference model/__init__.py:30-39 eval()s these at load)."""
    return (f"Dust3rEncoder(img_size={tuple(cfg.img_size)}, "
            f"patch_size={cfg.patch_size}, embed_dim={cfg.embed_dim}, "
            f"depth={cfg.depth}, num_heads={cfg.num_heads}, "
            f"mlp_ratio={cfg.mlp_ratio:g}, "
            f"pos_embed='{cfg.rope.spec_string()}')")


def decoder_config_to_arg_string(cfg: DecoderConfig) -> str:
    """Inverse of :func:`decoder_config_from_arg_string`; the class name
    follows ``cfg.causal`` (CausalMUSt3R = training semantics)."""
    name = "CausalMUSt3R" if cfg.causal else "MUSt3R"
    parts = [
        f"img_size={tuple(cfg.img_size)}",
        f"enc_embed_dim={cfg.enc_embed_dim}",
        f"patch_size={cfg.patch_size}",
        f"embed_dim={cfg.embed_dim}",
        f"output_dim={cfg.output_dim}",
        f"depth={cfg.depth}",
        f"num_heads={cfg.num_heads}",
        f"mlp_ratio={cfg.mlp_ratio:g}",
        f"pos_embed='{cfg.rope.spec_string()}'",
        f"landscape_only={cfg.landscape_only}",
        f"memory_mode='{cfg.memory_mode.value}'",
        f"pointmaps_activation='{cfg.pointmaps_activation.value}'",
        f"protected_imgs={cfg.protected_imgs}",
    ]
    if cfg.feedback != FeedbackType.NONE:
        parts.append(f"feedback_type='{cfg.feedback.value}'")
    return f"{name}({', '.join(parts)})"


def set_image_size(cfg, img_size: int):
    """Resolution transfer: rewrite img_size and install adaptive RoPE
    (reference: model/__init__.py:66-108). The RoPE base grid is the
    resolution the frequencies were tuned for."""
    old = max(cfg.img_size)
    # undo a previously-applied adaptation to recover the training base size
    base = int(round(old * cfg.rope.f0))
    new_rope = dataclasses.replace(cfg.rope, f0=base / img_size)
    return dataclasses.replace(cfg, img_size=(img_size, img_size), rope=new_rope)


# ---------------------------------------------------------------------------
# JSON round-trip (self-describing checkpoints without eval())
# ---------------------------------------------------------------------------

def config_to_json(cfg) -> str:
    d = dataclasses.asdict(cfg)
    d["__class__"] = type(cfg).__name__
    return json.dumps(d, default=lambda o: o.value if isinstance(o, Enum) else o)


def config_from_json(s: str):
    d = json.loads(s)
    cls = {"EncoderConfig": EncoderConfig, "DecoderConfig": DecoderConfig,
           "VGGTConfig": VGGTConfig}[d.pop("__class__")]
    if "rope" in d and isinstance(d["rope"], dict):
        d["rope"] = RoPEConfig(**d["rope"])
    for key in ("img_size", "dpt_out_channels", "dpt_layers"):
        if isinstance(d.get(key), list):
            d[key] = tuple(d[key])
    for key, enum_cls in (("memory_mode", MemoryMode), ("feedback", FeedbackType),
                          ("pointmaps_activation", ActivationType)):
        if key in d:
            d[key] = enum_cls(d[key])
    return cls(**d)
