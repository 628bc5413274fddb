"""Dataclass config tree for the whole framework.

The port's own copy of video_chapter_generation_tpu/core/config.py (every definition;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass
class DataConfig:
    """Copied from video_chapter_generation_tpu/core/config.py:18."""
    img_dir: str = ""
    data_file: str = ""
    subtitle_dir: Optional[str] = None
    train_vid_file: str = ""
    val_vid_file: str = ""
    test_vid_file: str = ""
    test_clips_json: str = ""

    clip_frame_num: int = 16
    max_offset: int = 2
    fps: int = 1
    max_text_len: int = 100
    # chapter-title generation
    title_input_len: int = 512
    title_decode_len: int = 30
    max_vision_emb: int = 10
    # window model
    window_size: int = 1
    # loader
    batch_size: int = 16
    num_workers: int = 4
    prefetch_depth: int = 2


@dataclass
class ModelConfig:
    """Copied from video_chapter_generation_tpu/core/config.py:44."""
    kind: str = "two_stream_window"  # see models.registry
    data_mode: str = "all"  # text | image | all
    head_type: str = "mlp"  # mlp | bilinear | multiplication | self_attn | cross_attn
    hidden_size: int = 128
    lang_embed_size: int = 768
    vision_embed_size: int = 2048
    # compute precision for matmul-heavy paths; params stay f32
    compute_dtype: str = "bfloat16"
    # vision
    tsm_n_div: int = 8
    tsm_place: str = "blockres"
    # TSM implementation: "auto" = per-stage best from the PERF.md sweep
    # (whole-block fused kernels for layers 1-2 at inference, pallas conv1
    # elsewhere/training); or one of tap3 | pallas | xla | fusedblk
    tsm_impl: str = "auto"
    # rematerialize each vision bottleneck in the backward pass: trades
    # ~1/3 more vision FLOPs for O(depth) less stored activation memory.
    # Unlocks b16+ window batches (OOM without) but measured SLOWER than
    # b8 without remat on v5e (1116 vs 1322 frames/s — PERF.md round 3),
    # so off by default; turn on for larger windows / longer clips.
    remat_vision: bool = False
    # stem input layout: "frames" = normalized float [.., H, W, 3];
    # "s2d" = raw uint8 4x4 space-to-depth [.., H/4, W/4, 48] as emitted
    # by the native decoder (data/native_loader.py) — the fused stems
    # normalize in VMEM, removing the on-device transpose + normalize
    # passes from BOTH the inference and training hot paths (PERF.md).
    stem_input: str = "frames"
    # pretrained checkpoint paths (converted from torch; optional)
    bert_init: Optional[str] = None
    vision_init: Optional[str] = None
    pegasus_init: Optional[str] = None


@dataclass
class OptimConfig:
    """Copied from video_chapter_generation_tpu/core/config.py:79."""
    learning_rate: float = 1e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    grad_norm_clip: float = 1.0
    gradient_accumulation_steps: int = 1
    # epoch-based schedule (train_video_segment_ddp.py:345-375)
    lr_decay: bool = True
    lr_decay_type: str = "cosine"  # cosine | exp
    warmup_epochs: int = 2
    final_epochs: int = 300


@dataclass
class MeshConfig:
    """Logical device mesh. data axis = batch sharding (DDP/ZeRO analogue),
    model axis reserved for tensor parallelism of large models.

    Copied from video_chapter_generation_tpu/core/config.py:93.
    """

    data_axis: int = -1  # -1: all devices
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")
    # shard optimizer state along data axis (ZeRO-like)
    shard_opt_state: bool = True


@dataclass
class TrainConfig:
    """Copied from video_chapter_generation_tpu/core/config.py:105."""
    max_epochs: int = 300
    eval_every_epochs: int = 30
    # checkpoint cadence. The reference saves every epoch
    # (train_video_segment_ddp.py:151-174) but at real model scale a
    # full train-state save is ~1.6 GB — on slow disks per-epoch saving
    # dominates wall clock (measured 300+ s/epoch, PERF.md round 4).
    # The final epoch always saves.
    save_every_epochs: int = 1
    seed: int = 123
    ckpt_dir: str = "checkpoints"
    keep_checkpoints: int = 10
    resume: bool = True
    log_dir: str = "logs"
    tensorboard: bool = True


@dataclass
class Config:
    """Copied from video_chapter_generation_tpu/core/config.py:123."""
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            data=_from(DataConfig, d.get("data", {})),
            model=_from(ModelConfig, d.get("model", {})),
            optim=_from(OptimConfig, d.get("optim", {})),
            mesh=_from(MeshConfig, d.get("mesh", {})),
            train=_from(TrainConfig, d.get("train", {})),
        )

    def apply_overrides(self, overrides: list[str]) -> "Config":
        """Apply `a.b=value` CLI overrides (JSON-parsed values)."""
        cfg = self
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override must be key=value: {ov!r}")
            key, raw = ov.split("=", 1)
            key = key.lstrip("-")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            parts = key.split(".")
            cfg = _set_nested(cfg, parts, value)
        return cfg


def _from(cls, d: dict):
    """Copied from video_chapter_generation_tpu/core/config.py:166."""
    names = {f.name for f in dataclasses.fields(cls)}
    clean = {}
    for k, v in d.items():
        if k not in names:
            raise ValueError(f"unknown config field {cls.__name__}.{k}")
        fld = next(f for f in dataclasses.fields(cls) if f.name == k)
        if fld.type in ("Tuple[float, float]", "Tuple[str, str]") and isinstance(
            v, list
        ):
            v = tuple(v)
        clean[k] = v
    return cls(**clean)


def _set_nested(obj, parts, value):
    """Copied from video_chapter_generation_tpu/core/config.py:181."""
    if len(parts) == 1:
        name = parts[0]
        if not hasattr(obj, name):
            raise ValueError(f"unknown config field {type(obj).__name__}.{name}")
        cur = getattr(obj, name)
        if isinstance(cur, tuple) and isinstance(value, list):
            value = tuple(value)
        return dataclasses.replace(obj, **{name: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _set_nested(child, parts[1:], value)})
