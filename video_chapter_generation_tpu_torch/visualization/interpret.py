"""Model interpretability on the port (counterpart of the JAX package's
visualization/interpret.py): Grad-CAM for the vision stream, saliency and
integrated gradients for the language stream.

- grad_cam_vision captures a stage's output on the serving forward
  (ResNet capture), differentiates the class score with respect to it by
  re-entering the trunk there (ResNet from_stage), weights the channels by
  their spatially pooled gradients and keeps the positive part
  (cam_visualization.py:24).
- saliency_lang and integrated_gradients_lang differentiate the logit
  with respect to the word embeddings, fed in place of the lookup
  (BertModel input_embeds; saliency_interpreter.py:9-231,
  integrated_gradient.py:7-78).

The models run as they are, in eval() mode (the JAX functions apply them
deterministically). On the card at the last stage (the default) the
capture forward runs the inference kernels and the re-entry is the pool
and the head; at an earlier stage the re-entered blocks need a backward,
which the whole-block and K5 inference kernels do not have: under
tsm_impl "auto" their wrappers raise, and tsm_impl "tap3" or "xla" (the
plain inference routes) differentiate. The maps are computed in at least
float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.tsm_block_train import at_least_f32


def _eval_only(model: torch.nn.Module) -> None:
    if model.training:
        raise ValueError(f"{type(model).__name__} is in train() mode: the "
                         "interpretability maps take an eval() model")


def _normalize(x: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """x / denom (a row's sum or max) where that is positive."""
    return x / torch.where(denom > 0, denom, torch.ones_like(denom))


def grad_cam_vision(resnet, frames: torch.Tensor, class_index: int = 1,
                    stage: int = 4,
                    head_fn: Optional[Callable] = None) -> torch.Tensor:
    """Grad-CAM heatmaps for a batch of frames (JAX :22-56).

    resnet: models.resnet.ResNet in eval(); frames: what its forward takes
    ([N, H, W, 3], or the s2d pack; N = clips * n_segment under TSM).
    head_fn: pooled features [N, D] -> logits [N, classes]; without one
    the score is the features' sum. -> cam [N, h_s, w_s] in [0, 1]."""
    _eval_only(resnet)
    capture: dict = {}
    resnet(frames, capture=capture)
    act = capture[f"stage{stage}"].detach().requires_grad_()
    with torch.enable_grad():
        pooled = resnet(act, from_stage=stage)
        score = (head_fn(pooled)[:, class_index] if head_fn is not None
                 else pooled).sum()
        grads, = torch.autograd.grad(score, act)
    a, g = at_least_f32(act.detach()), at_least_f32(grads)
    weights = g.mean(dim=(1, 2), keepdim=True)
    cam = torch.relu((weights * a).sum(-1))
    return _normalize(cam, cam.amax(dim=(1, 2), keepdim=True))


def _lang_logit_fn(bert_chapter, text_ids, attention_mask,
                   class_index: int):
    """(the word embeddings of text_ids, logit(embeds) -> the summed class
    logit) for models.bert.BertForChapter (JAX :59-70)."""
    _eval_only(bert_chapter)
    table = bert_chapter.base_model.embeddings.word_embeddings.weight
    base_emb = table.detach()[text_ids.long()]

    def logit(embeds):
        logits, _ = bert_chapter(text_ids, attention_mask,
                                 input_embeds=embeds)
        return logits[:, class_index].sum()

    return base_emb, logit


def _grad(logit, embeds: torch.Tensor) -> torch.Tensor:
    e = embeds.detach().requires_grad_()
    with torch.enable_grad():
        g, = torch.autograd.grad(logit(e), e)
    return g


def saliency_lang(bert_chapter, text_ids, attention_mask,
                  class_index: int = 1) -> torch.Tensor:
    """Simple-gradient token saliency: the L2 norm of d logit / d
    embedding per token, masked and normalized to sum 1 per example (JAX
    :73-83). -> [B, L]."""
    base_emb, logit = _lang_logit_fn(bert_chapter, text_ids, attention_mask,
                                     class_index)
    grads = at_least_f32(_grad(logit, base_emb))
    sal = torch.linalg.vector_norm(grads, dim=-1) * attention_mask.to(
        grads.dtype)
    return _normalize(sal, sal.sum(-1, keepdim=True))


def integrated_gradients_lang(bert_chapter, text_ids, attention_mask,
                              class_index: int = 1,
                              steps: int = 16) -> torch.Tensor:
    """Integrated gradients along the straight path from the zero embedding
    to the input's (JAX :86-108): the mean of the gradients at alpha =
    (i + 1) / steps, i < steps (a Python loop where JAX runs fori_loop),
    attribution |(emb - 0) . mean gradient| per token, masked and
    normalized to sum 1 per example. -> [B, L]."""
    base_emb, logit = _lang_logit_fn(bert_chapter, text_ids, attention_mask,
                                     class_index)
    total = torch.zeros_like(at_least_f32(base_emb))
    for i in range(steps):
        total = total + at_least_f32(_grad(logit, base_emb * ((i + 1)
                                                              / steps)))
    avg = total / steps
    attr = (at_least_f32(base_emb) * avg).sum(-1) * attention_mask.to(
        avg.dtype)
    attr = attr.abs()
    return _normalize(attr, attr.sum(-1, keepdim=True))
