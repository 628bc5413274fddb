"""Training tasks (counterpart of the JAX package's train/tasks.py):
SegmentWindowTask, the flagship window model of :87-166 with its AUC/mAP
eval; SegmentTask, the base two-stream clip classifier of :169-213;
SegmentTextTask, the subtitle-only classifier of :216-268;
LangPretrainTask, the BERT subtitle pretraining of :270-294;
GptPretrainTask and GptGlovePretrainTask, the from-scratch GPT's of
:297-362; TitleGenTask
(:365-419) and TitleGenVisionTask (:422-462), the title models with
their loss and eval.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.contract import build_contract
from ..evalkit.metrics import average_precision_score, roc_auc_score
from ..models import convert
from ..models.bert import BertConfig, BertForChapter, BertModel
from ..models.fusion import (
    WINDOW_HEAD_TYPES,
    TwoStream,
    TwoStreamWindow,
    _autocast,
)
from ..models.gpt import GPT, GPTConfig
from ..models.resnet import STAGE_SIZES, ResNet
from ..models.seq2seq import Seq2Seq, Seq2SeqConfig, Seq2SeqVisionEmb
from ..ops.preprocess import normalize_frames
from .objectives import (
    clip_classification_loss,
    masked_token_loss,
    seq2seq_title_loss,
)

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


class _SegmentBase:
    """What the two clip classifiers share: the streams' configuration
    (train/tasks.py:33-59: the ResNet takes model.tsm_impl and
    model.remat_vision), frame preparation and the device batch."""

    def __init__(self, cfg: Config, tiny: bool, hw: int,
                 bert_cfg: Optional[BertConfig]):
        self.cfg = cfg
        self.hw = hw
        self.dtype = compute_dtype(cfg)
        self.bert_cfg = bert_cfg or (BertConfig.tiny() if tiny
                                     else BertConfig())
        self.stage_sizes = TINY_STAGE_SIZES if tiny else STAGE_SIZES[50]

    def _streams(self):
        m = self.cfg.model
        return (BertModel(self.bert_cfg),
                ResNet(50, n_segment=self.cfg.data.clip_frame_num,
                       n_div=m.tsm_n_div, stem_input=m.stem_input,
                       stage_sizes=self.stage_sizes, dtype=self.dtype,
                       tsm_impl=m.tsm_impl, remat=m.remat_vision))

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Seeded random weights (train.seed) drawn in the JAX layout and
        carried over by models/convert.py, as a float32 state dict (float64
        under model.compute_dtype=float64)."""
        tree = convert.random_jax_tree(self.model, self.entries,
                                       seed=self.cfg.train.seed)
        return _init_dtype(convert._with_bn_counters(
            convert.from_jax(tree, self.entries)), self.dtype)

    def _batch(self, model, batch, img_key: str):
        """(frames, ids, mask) on the model's device. uint8 frames for a
        frames stem are normalized there, to the compute dtype (K6; train/
        tasks.py:62-70); an s2d pack goes in raw."""
        dev = model.lang_model.pooler.dense.weight.device
        put = lambda k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)  # noqa: E731
        img = put(img_key)
        if self.cfg.model.stem_input != "s2d":
            img = normalize_frames(img, self.dtype)
        return img, put("text_ids").long(), put("attention_mask")


class SegmentWindowTask(_SegmentBase):
    """The flagship: TwoStreamWindow, binary clip cross entropy, AUC/mAP
    eval (train/tasks.py:87-166). head_dropout is the heads' dropout rate
    (0 turns it off, as the JAX package's deterministic=True does)."""

    def __init__(self, cfg: Config, tiny: bool = False, hw: int = 224,
                 bert_cfg: Optional[BertConfig] = None,
                 head_dropout: float = 0.1):
        super().__init__(cfg, tiny, hw, bert_cfg)
        seg = cfg.data.clip_frame_num
        with torch.device("meta"):
            self.model = TwoStreamWindow(
                *self._streams(), window_size=cfg.data.window_size,
                segment_size=seg, hidden_size=cfg.model.hidden_size,
                head_type=cfg.model.head_type, dtype=self.dtype,
                dropout=head_dropout)
        self.entries = convert.two_stream_window_entries(
            self.bert_cfg.num_layers, self.stage_sizes, cfg.model.head_type)
        self.contract = build_contract(
            model_kind="two_stream_window", head_type=cfg.model.head_type,
            clip_frame_num=seg, window_size=cfg.data.window_size,
            max_text_len=cfg.data.max_text_len, frame_hw=hw,
            data_mode=cfg.model.data_mode)

    def loss_fn(self, model: TwoStreamWindow, batch: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None):
        img, ids, mask = self._batch(model, batch, "img_clips")
        logits, _ = model(img, ids, mask, train=True, generator=generator)
        return clip_classification_loss(logits, torch.as_tensor(
            batch["label"]).to(logits.device))

    def eval_fn(self, model: TwoStreamWindow, loader):
        """(mAP, {"auc", "m_ap"}) of the positive-class scores over the
        loader; both 0 when the labels hold one class only."""
        scores, labels = [], []
        for batch in loader:
            _, prob = model.serve(*self._batch(model, batch, "img_clips"))
            scores.append(prob[:, 1].float().cpu().numpy())
            labels.append(np.asarray(batch["label"]))
        return _binary_eval(scores, labels)


class SegmentTask(_SegmentBase):
    """Base (non-window) two-stream clip classifier: BERT + ResNet50-TSM +
    the ChapterHead, binary clip cross entropy. model.head_type "attn"
    builds the attention head; a window-only type builds the mlp head,
    as the JAX task does (:183-184), and the contract records the type
    asked for."""

    def __init__(self, cfg: Config, tiny: bool = False, hw: int = 224,
                 bert_cfg: Optional[BertConfig] = None):
        super().__init__(cfg, tiny, hw, bert_cfg)
        seg = cfg.data.clip_frame_num
        asked = cfg.model.head_type
        if asked not in ("attn",) + WINDOW_HEAD_TYPES:
            raise ValueError(f"unknown head_type {asked}")
        head = "attn" if asked == "attn" else "mlp"
        with torch.device("meta"):
            self.model = TwoStream(*self._streams(), segment_size=seg,
                                   hidden_size=cfg.model.hidden_size,
                                   head_type=head, dtype=self.dtype)
        self.entries = convert.two_stream_entries(self.bert_cfg.num_layers,
                                                  self.stage_sizes, head)
        self.contract = build_contract(
            model_kind="two_stream", head_type=asked,
            clip_frame_num=seg, max_text_len=cfg.data.max_text_len,
            frame_hw=hw, data_mode=cfg.model.data_mode)

    def loss_fn(self, model: TwoStream, batch: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None):
        """(loss, metrics) of one host batch on the model's device."""
        img, ids, mask = self._batch(model, batch, "img_clip")
        logits, _ = model(img, ids, mask, train=True, generator=generator)
        return clip_classification_loss(logits, torch.as_tensor(
            batch["label"]).to(logits.device))


def _init_dtype(state: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """float64 compute keeps float64 weights; other dtypes keep float32
    weights (bf16 runs under autocast on the card)."""
    if dtype != torch.float64:
        return state
    return {k: v.double() if v.is_floating_point() else v
            for k, v in state.items()}


def _put(model: torch.nn.Module, batch, *keys):
    dev = next(model.parameters()).device
    return [torch.as_tensor(np.asarray(batch[k])).to(dev, non_blocking=True)
            for k in keys]


def _binary_eval(scores, labels):
    """(mAP, {"auc", "m_ap"}); both 0 when the labels hold one class."""
    y, s = np.concatenate(labels), np.concatenate(scores)
    if 0 < y.sum() < len(y):
        auc = roc_auc_score(y, s)
        m_ap = average_precision_score(y, s)
    else:
        auc = m_ap = 0.0
    return m_ap, {"auc": auc, "m_ap": m_ap}


class SegmentTextTask:
    """The subtitle-only boundary classifier (train/tasks.py:216-268):
    BertForChapter's chapter head over the pooled text, binary clip cross
    entropy, AUC/mAP eval. vocab_size sets the BERT vocabulary (the
    tokenizer's, as the JAX task does); bert_cfg overrides the whole
    BERT configuration."""

    def __init__(self, cfg: Config, tiny: bool = False,
                 vocab_size: Optional[int] = None,
                 bert_cfg: Optional[BertConfig] = None):
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        bc = bert_cfg or (BertConfig.tiny() if tiny else BertConfig())
        if vocab_size is not None:
            bc = dataclasses.replace(bc, vocab_size=vocab_size)
        self.bert_cfg = bc
        with torch.device("meta"):
            self.model = BertForChapter(bc, pretrain_stage=False)
        self.entries = convert.bert_for_chapter_entries(bc.num_layers)
        self.contract = build_contract(
            model_kind="text", max_text_len=cfg.data.max_text_len,
            vocab_size=bc.vocab_size)

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Seeded random weights (train.seed) in the JAX layout."""
        tree = convert.random_jax_tree(self.model, self.entries,
                                       seed=self.cfg.train.seed)
        return _init_dtype(convert.from_jax(tree, self.entries), self.dtype)

    def loss_fn(self, model: BertForChapter, batch: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None):
        ids, mask, label = _put(model, batch, "text_ids", "attention_mask",
                                "label")
        with _autocast(self.dtype, ids.device):
            logits, _ = model(ids.long(), mask, generator=generator)
        return clip_classification_loss(logits, label)

    def eval_fn(self, model: BertForChapter, loader):
        """(mAP, {"auc", "m_ap"}) of the positive-class scores."""
        scores, labels = [], []
        with torch.no_grad():
            for batch in loader:
                ids, mask = _put(model, batch, "text_ids", "attention_mask")
                with _autocast(self.dtype, ids.device):
                    _, prob = model(ids.long(), mask)
                scores.append(prob[:, 1].float().cpu().numpy())
                labels.append(np.asarray(batch["label"]))
        return _binary_eval(scores, labels)


class LangPretrainTask:
    """BERT subtitle pretraining, MLM or next token (train/tasks.py:270):
    BertForChapter with the bias-free vocabulary head (pretrain_stage),
    the masked-token cross entropy over SubtitlePretrainDataset items
    ("text_ids", "attention_mask", "targets"), dropout from the caller's
    generator. The model computes in model.compute_dtype (bf16 under
    autocast with float32 weights on the card; float64 keeps float64
    weights); the JAX task builds its BERT in float32 whatever the
    config says. bert_cfg overrides the BERT configuration (its
    vocabulary is vocab_size)."""

    def __init__(self, cfg: Config, vocab_size: int, tiny: bool = False,
                 bert_cfg: Optional[BertConfig] = None):
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        bc = bert_cfg or (BertConfig.tiny() if tiny else BertConfig())
        self.bert_cfg = bc = dataclasses.replace(bc, vocab_size=vocab_size)
        with torch.device("meta"):
            self.model = BertForChapter(bc, pretrain_stage=True)
        self.entries = convert.bert_for_chapter_entries(bc.num_layers,
                                                        pretrain_stage=True)
        self.contract = build_contract(
            model_kind="lang_pretrain", max_text_len=cfg.data.max_text_len,
            vocab_size=vocab_size)

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Seeded random weights (train.seed) in the JAX layout."""
        tree = convert.random_jax_tree(self.model, self.entries,
                                       seed=self.cfg.train.seed)
        return _init_dtype(convert.from_jax(tree, self.entries), self.dtype)

    def loss_fn(self, model: BertForChapter, batch: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None):
        """(loss, {"loss", "acc"}) of one host batch on the model's
        device, with dropout from `generator` in train() mode."""
        ids, mask, targets = _put(model, batch, "text_ids",
                                  "attention_mask", "targets")
        with _autocast(self.dtype, ids.device):
            logits, _ = model(ids.long(), mask, generator=generator)
        return masked_token_loss(logits, targets)


class GptPretrainTask:
    """From-scratch GPT next-token pretraining on word ids
    (train/tasks.py:297-326, contract "gpt_pretrain"): GPTConfig with
    n_layer 12, n_head 10, n_embd 300 and block_size max_text_len (tiny:
    2 layers, 2 heads, 64), the masked next-token loss over
    WordIdSubtitleDataset items ("text_ids", "targets"), dropout from the
    caller's generator. The model computes in model.compute_dtype (bf16
    under autocast with float32 weights on the card; float64 keeps
    float64 weights); the JAX task builds its GPT in float32 whatever the
    config says. gpt_cfg overrides the configuration (its vocabulary is
    vocab_size)."""

    _input = "text_ids"
    _kind = "gpt_pretrain"

    def __init__(self, cfg: Config, vocab_size: int, tiny: bool = False,
                 gpt_cfg: Optional[GPTConfig] = None):
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        gc = gpt_cfg or self._default_cfg(cfg, tiny)
        self.gpt_cfg = gc = dataclasses.replace(gc, vocab_size=vocab_size)
        with torch.device("meta"):
            self.model = GPT(gc)
        self.entries = convert.gpt_entries(gc)
        self.contract = build_contract(model_kind=self._kind,
                                       max_text_len=cfg.data.max_text_len,
                                       vocab_size=vocab_size,
                                       **self._contract_extra())

    def _default_cfg(self, cfg: Config, tiny: bool) -> GPTConfig:
        return GPTConfig(block_size=cfg.data.max_text_len,
                         n_layer=2 if tiny else 12,
                         n_head=2 if tiny else 10,
                         n_embd=64 if tiny else 300)

    def _contract_extra(self) -> dict:
        return {}

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Seeded random weights (train.seed) in the JAX layout."""
        tree = convert.random_jax_tree(self.model, self.entries,
                                       seed=self.cfg.train.seed)
        return _init_dtype(convert.from_jax(tree, self.entries), self.dtype)

    def loss_fn(self, model: GPT, batch: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None):
        """(loss, {"loss", "acc"}) of one host batch on the model's
        device, with dropout from `generator` in train() mode."""
        x, targets = _put(model, batch, self._input, "targets")
        with _autocast(self.dtype, x.device):
            logits = model(x, generator=generator)
        return masked_token_loss(logits, targets)


class GptGlovePretrainTask(GptPretrainTask):
    """From-scratch GPT next-token pretraining on GloVe word embeddings
    (train/tasks.py:329-362, contract "gpt_glove_pretrain" with emb_dim):
    inputs are [B, L, emb_dim] embedding rows (GloveSubtitleDataset's
    "embeddings"), targets vocabulary ids; n_head 12, n_embd emb_dim
    (tiny: 2 layers, 2 heads). Computes as GptPretrainTask does."""

    _input = "embeddings"
    _kind = "gpt_glove_pretrain"

    def __init__(self, cfg: Config, vocab_size: int, tiny: bool = False,
                 emb_dim: int = 300, gpt_cfg: Optional[GPTConfig] = None):
        self.emb_dim = emb_dim
        super().__init__(cfg, vocab_size, tiny, gpt_cfg)

    def _default_cfg(self, cfg: Config, tiny: bool) -> GPTConfig:
        return GPTConfig(block_size=cfg.data.max_text_len,
                         n_layer=2 if tiny else 12,
                         n_head=2 if tiny else 12, n_embd=self.emb_dim,
                         using_pretrained_embed=True)

    def _contract_extra(self) -> dict:
        return {"emb_dim": self.emb_dim}


class TitleGenTask:
    """Seq2seq chapter titles (Pegasus, BigBird-Pegasus or BART, as the
    Seq2SeqConfig says; train/tasks.py:365-419): the model (built on the
    meta device), its seeded random weights, its contract, which records
    the encoder's attention (full or block_sparse) as the JAX task does
    (:376), the teacher-forced title loss and its eval. bf16 compute runs
    under autocast on the card with float32 weights."""

    _inputs = ("text_ids", "attention_mask")

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
        over as a float32 state dict (float64 under
        model.compute_dtype=float64)."""
        tree = convert.random_jax_tree(self.model, self.entries,
                                       seed=self.cfg.train.seed)
        return _init_dtype(convert.from_jax(tree, self.entries), self.dtype)

    def _metrics(self, model, batch, generator=None):
        """The title loss of one host batch on the model's device."""
        keys = self._inputs + ("input_decode_ids", "decode_attention_mask",
                               "target_decode_ids")
        args = [t.long() if k.endswith("_ids") else t
                for k, t in zip(keys, _put(model, batch, *keys))]
        with _autocast(self.dtype, args[0].device):
            logits = model(*args[:-1], generator=generator)
        return seq2seq_title_loss(logits, args[-1], args[-2])

    def loss_fn(self, model, batch: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None):
        """(loss, {"loss", "acc"}) with dropout from `generator` in
        train() mode (train/tasks.py:385-395)."""
        return self._metrics(model, batch, generator)

    def eval_fn(self, model, loader):
        """(-mean loss, {"loss", "acc"}) over the loader, the means of the
        per-batch values (train/tasks.py:397-419)."""
        losses, accs = [], []
        with torch.no_grad():
            for batch in loader:
                _, m = self._metrics(model, batch)
                losses.append(float(m["loss"]))
                accs.append(float(m["acc"]))
        return -float(np.mean(losses)), {"loss": float(np.mean(losses)),
                                         "acc": float(np.mean(accs))}


class TitleGenVisionTask(TitleGenTask):
    """Vision-conditioned titles (JAX :422-462, the PegasusVisionEmb
    recipe): Seq2SeqVisionEmb over the configured title family, its seeded
    random weights (train.seed), the contract of model_kind
    "title_vision", which also records the fusion type and the vision
    embedding width, and the title loss over the fused encoder states. Its
    eval is TitleGenTask's on the vision forward; the JAX task inherits
    one that feeds the vision model the plain model's inputs and fails
    (ROADMAP, the JAX package's faults)."""

    _inputs = ("vision_embs", "vision_attention_mask", "text_ids",
               "attention_mask")

    def __init__(self, cfg: Config, seq2seq_cfg: Seq2SeqConfig,
                 fusion_type: str = "cross_attn",
                 vision_emb_size: int = 2048):
        self.cfg = cfg
        self.s2s_cfg = seq2seq_cfg
        self.dtype = compute_dtype(cfg)
        self.fusion_type = fusion_type
        self.vision_emb_size = vision_emb_size
        with torch.device("meta"):
            self.model = Seq2SeqVisionEmb(seq2seq_cfg, fusion_type,
                                          vision_emb_size)
        self.entries = convert.vision_title_entries(seq2seq_cfg, fusion_type)
        self.contract = build_contract(
            model_kind="title_vision", fusion_type=fusion_type,
            vision_emb_size=vision_emb_size,
            title_input_len=cfg.data.title_input_len,
            title_decode_len=cfg.data.title_decode_len,
            vocab_size=seq2seq_cfg.vocab_size,
            encoder_attention=seq2seq_cfg.encoder_attention,
            d_model=seq2seq_cfg.d_model)
