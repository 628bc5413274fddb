"""Training tasks (counterpart of the JAX package's train/tasks.py):
SegmentTask, the base two-stream clip classifier of :169-213, and of
TitleGenTask (:365-383) the model, its weights and its contract, which
serving needs (its loss and eval are ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.contract import build_contract
from ..models import convert
from ..models.bert import BertConfig, BertModel
from ..models.fusion import TwoStream
from ..models.resnet import STAGE_SIZES, ResNet
from ..models.seq2seq import Seq2Seq, Seq2SeqConfig
from ..ops.preprocess import normalize_frames
from .objectives import clip_classification_loss

TINY_STAGE_SIZES = (1, 1, 1, 1)


def compute_dtype(cfg: Config) -> torch.dtype:
    """model.compute_dtype: bf16 computes in bfloat16 with float32
    parameters, BN statistics and loss (train/tasks.py:37); float64 (as
    the JAX package's trajectory tests run under x64) computes and keeps
    everything in float64; anything else is float32."""
    if cfg.model.compute_dtype in ("bfloat16", "bf16"):
        return torch.bfloat16
    if cfg.model.compute_dtype == "float64":
        return torch.float64
    return torch.float32


class SegmentTask:
    """Base (non-window) two-stream clip classifier: BERT + ResNet50-TSM +
    the mlp ChapterHead, binary clip cross entropy."""

    def __init__(self, cfg: Config, tiny: bool = False, hw: int = 224,
                 bert_cfg: Optional[BertConfig] = None):
        self.cfg = cfg
        self.hw = hw
        seg = cfg.data.clip_frame_num
        self.dtype = compute_dtype(cfg)
        self.bert_cfg = bert_cfg or (BertConfig.tiny() if tiny
                                     else BertConfig())
        self.stage_sizes = TINY_STAGE_SIZES if tiny else STAGE_SIZES[50]
        if cfg.model.head_type != "mlp":
            raise NotImplementedError(
                f"head_type {cfg.model.head_type!r} is not ported")
        with torch.device("meta"):
            self.model = TwoStream(
                BertModel(self.bert_cfg),
                ResNet(50, n_segment=seg, n_div=cfg.model.tsm_n_div,
                       stem_input=cfg.model.stem_input,
                       stage_sizes=self.stage_sizes, dtype=self.dtype),
                segment_size=seg, hidden_size=cfg.model.hidden_size,
                head_type="mlp", dtype=self.dtype)
        self.entries = convert.two_stream_entries(self.bert_cfg.num_layers,
                                                  self.stage_sizes)
        self.contract = build_contract(
            model_kind="two_stream", head_type=cfg.model.head_type,
            clip_frame_num=seg, max_text_len=cfg.data.max_text_len,
            frame_hw=hw, data_mode=cfg.model.data_mode)

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Seeded random weights (train.seed) drawn in the JAX layout and
        carried over by models/convert.py, as a float32 state dict."""
        tree = convert.random_jax_tree(self.model, self.entries,
                                       seed=self.cfg.train.seed)
        return convert.from_jax_two_stream(tree, self.bert_cfg.num_layers,
                                           self.stage_sizes)

    def loss_fn(self, model: TwoStream, batch: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None):
        """(loss, metrics) of one host batch on the model's device. uint8
        frames for a frames stem are normalized there, to the compute
        dtype (train/tasks.py:62-70); an s2d pack goes in raw."""
        dev = model.fusion_head.head.weight.device
        put = lambda k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)  # noqa: E731
        img = put("img_clip")
        if self.cfg.model.stem_input != "s2d":
            img = normalize_frames(img, self.dtype)
        logits, _ = model(img, put("text_ids").long(),
                          put("attention_mask"), train=True,
                          generator=generator)
        return clip_classification_loss(logits, put("label"))


class TitleGenTask:
    """Seq2seq chapter titles (Pegasus, BigBird-Pegasus or BART, as the
    Seq2SeqConfig says): the model (built on the meta device), its seeded
    random weights and its contract, which records the encoder's
    attention (full or block_sparse) as the JAX task does (:376)."""

    def __init__(self, cfg: Config, seq2seq_cfg: Seq2SeqConfig):
        self.cfg = cfg
        self.s2s_cfg = seq2seq_cfg
        self.dtype = compute_dtype(cfg)
        with torch.device("meta"):
            self.model = Seq2Seq(seq2seq_cfg)
        self.entries = convert.seq2seq_entries(seq2seq_cfg)
        self.contract = build_contract(
            model_kind="title", title_input_len=cfg.data.title_input_len,
            title_decode_len=cfg.data.title_decode_len,
            vocab_size=seq2seq_cfg.vocab_size,
            encoder_attention=seq2seq_cfg.encoder_attention,
            d_model=seq2seq_cfg.d_model)

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Seeded random weights (train.seed) in the JAX layout, carried
        over as a float32 state dict."""
        tree = convert.random_jax_tree(self.model, self.entries,
                                       seed=self.cfg.train.seed)
        return convert.from_jax_seq2seq(tree, self.s2s_cfg)
