"""Typed configuration of the port (counterpart of `instancediffusion_tpu/config.py`).

The sections the generate and training paths read, copied field for field
from the JAX package so the port imports nothing of it: diffusion schedule,
UNet with its UniFusion grounding tokenizer, VAE, CLIP text tower, sampler
defaults, data and training knobs. The refiner section stays with the JAX
package.
`tests/test_torch_bridge.py` holds the copies' defaults equal to the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DiffusionConfig:
    beta_schedule: str = "linear"
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012


@dataclass
class UniFusionConfig:
    in_dim: int = 768
    out_dim: int = 768
    mid_dim: int = 3072
    fourier_freqs: int = 16
    fourier_freqs_polygons: int = 16
    n_scribble_points: int = 20
    n_polygon_points: int = 256
    train_add_boxes: bool = True
    train_add_points: bool = True
    train_add_scribbles: bool = True
    train_add_masks: bool = True
    test_drop_boxes: bool = False
    test_drop_points: bool = False
    test_drop_scribbles: bool = True
    test_drop_masks: bool = False
    use_seperate_tokenizer: bool = True  # (sic: the reference's spelling)
    # seg branch: stacked instance masks (max_objs channels) -> ConvNeXt
    seg_channels: int = 30
    seg_resize_input: int = 512
    seg_down_factor: int = 64
    convnext_feature_dim: int = 3072
    convnext_depths: tuple[int, ...] = (3, 3, 9, 3)
    convnext_dims: tuple[int, ...] = (96, 192, 384, 768)

    @property
    def use_segs(self) -> bool:
        return self.train_add_masks

    @property
    def num_seg_tokens(self) -> int:
        return (self.seg_resize_input // self.seg_down_factor) ** 2  # 64


@dataclass
class UNetConfig:
    image_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    attention_resolutions: tuple[int, ...] = (4, 2, 1)
    num_res_blocks: int = 2
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    fuser_type: str = "gatedSA"
    use_checkpoint: bool = True
    sd_v1_5: bool = True
    efficient_attention: bool = True   # long attention -> the flash kernel
    dropout: float = 0.0
    max_objs: int = 30
    use_masked_att: bool = False
    grounding_tokenizer: UniFusionConfig = field(default_factory=UniFusionConfig)


@dataclass
class VAEConfig:
    scale_factor: float = 0.18215
    embed_dim: int = 4
    double_z: bool = True
    z_channels: int = 4
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple[int, ...] = ()
    dropout: float = 0.0


@dataclass
class TextEncoderConfig:
    # CLIP ViT-L/14 text tower
    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12


@dataclass
class SamplerConfig:
    steps: int = 50
    guidance_scale: float = 7.5
    alpha: float = 0.75           # fraction of steps with gate scale 1
    mis: float = 0.36             # fraction of steps using MIS trajectories
    negative_prompt: str = (
        "longbody, lowres, bad anatomy, bad hands, missing fingers, extra "
        "digit, fewer digits, cropped, worst quality, low quality"
    )
    num_images: int = 8
    seed: int = 0
    cascade_strength: float = 0.0
    sampler: str = "plms"


@dataclass
class DataConfig:
    image_size: int = 512
    max_boxes_per_data: int = 30
    prob_use_caption: float = 1.0
    random_crop: bool = False
    random_flip: bool = True
    which_layer_text: str = "before"


@dataclass
class TrainConfig:
    batch_size: int = 8
    base_learning_rate: float = 5e-5
    weight_decay: float = 0.0
    warmup_steps: int = 5000
    scheduler_type: str = "constant"  # or "cosine"
    total_iters: int = 500000
    save_every_iters: int = 10000
    ckpt_every_iters: int = 2000
    ema_rate: float = 0.9999
    enable_ema: bool = True
    gradient_checkpointing: bool = True
    zero1: bool = True
    seed: int = 123
    workers: int = 4
    official_ckpt_name: str = "v1-5-pruned-emaonly.ckpt"
    name: str = "test"
    output_dir: str = "OUTPUT"
    wandb: bool = False
    n_sample_batches: int = 10
    sample_steps: int = 50


@dataclass
class Config:
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    model: UNetConfig = field(default_factory=UNetConfig)
    autoencoder: VAEConfig = field(default_factory=VAEConfig)
    text_encoder: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _update_dataclass(obj: Any, updates: dict[str, Any]) -> Any:
    names = {f.name for f in dataclasses.fields(obj)}
    unknown = set(updates) - names
    if unknown:
        raise KeyError(f"{type(obj).__name__} has no fields {sorted(unknown)}")
    kwargs = {}
    for name, val in updates.items():
        cur = getattr(obj, name)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            kwargs[name] = _update_dataclass(cur, val)
        elif isinstance(cur, tuple) and isinstance(val, (list, tuple)):
            kwargs[name] = tuple(val)
        else:
            kwargs[name] = val
    return dataclasses.replace(obj, **kwargs)


def load_config(path: str | None = None, overrides: dict[str, Any] | None = None) -> Config:
    """A Config from an optional YAML file plus a nested override dict; a
    key the port's config does not have raises."""
    cfg = Config()
    if path is not None:
        import yaml

        with open(path) as f:
            cfg = _update_dataclass(cfg, yaml.safe_load(f) or {})
    if overrides:
        cfg = _update_dataclass(cfg, overrides)
    return cfg


# grounding modality selections of the reference's test configs
TEST_PRESETS: dict[str, dict[str, bool]] = {
    "box": dict(test_drop_boxes=False, test_drop_points=False,
                test_drop_scribbles=True, test_drop_masks=True),
    "point": dict(test_drop_boxes=True, test_drop_points=False,
                  test_drop_scribbles=True, test_drop_masks=True),
    "scribble": dict(test_drop_boxes=False, test_drop_points=False,
                     test_drop_scribbles=False, test_drop_masks=False),
    "mask": dict(test_drop_boxes=False, test_drop_points=False,
                 test_drop_scribbles=True, test_drop_masks=False),
    "all": dict(test_drop_boxes=False, test_drop_points=False,
                test_drop_scribbles=True, test_drop_masks=False),
}


def apply_test_preset(cfg: Config, preset: str) -> Config:
    gt = dataclasses.replace(cfg.model.grounding_tokenizer, **TEST_PRESETS[preset])
    model = dataclasses.replace(cfg.model, grounding_tokenizer=gt)
    return dataclasses.replace(cfg, model=model)
