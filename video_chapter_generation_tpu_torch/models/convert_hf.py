"""HuggingFace checkpoints -> the port's state dicts (counterpart of the
JAX package's models/resnet.py:1037 `convert_hf_resnet` and
models/seq2seq.py:780 `convert_hf_seq2seq`).

- `convert_hf_resnet`: a `transformers.ResNetModel` state dict
  (microsoft/resnet-50 lineage: the v1.5 bottleneck, stride on the 3x3)
  -> the port ResNet's torchvision-layout state dict;
- `convert_hf_seq2seq`: a Pegasus, BART or BigBirdPegasus
  `...ForConditionalGeneration` state dict -> the port `Seq2Seq`'s. The
  port's module names are Pegasus/BART's, so those pass through; a
  BigBirdPegasus dict has its encoder self-attention
  (`self_attn.self.{query,key,value}`, `self_attn.output`) and its final
  pre-norm LayerNorms (`layernorm_embedding`) renamed.

Each returns CPU tensors holding exactly the values of the dict it was
given, every key of the port's (float) model and no other, so the model
loads the result with strict=True.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .convert_reference import _t

StateDict = Dict[str, torch.Tensor]
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def convert_hf_resnet(state_dict: Dict[str, Any]) -> StateDict:
    """An HF `ResNetModel` state dict -> the port ResNet's state dict (the
    key map of JAX models/resnet.py:1037-1088): embedder -> conv1 / bn1;
    encoder.stages.{s}.layers.{b}.layer.{0,1,2} -> layer{s+1}.{b}.conv1..3
    and bn1..3; .shortcut -> downsample.0 / downsample.1. The BN counters
    (num_batches_tracked, which the JAX variables do not hold) are copied
    where the dict has them, else 0."""
    out: StateDict = {}

    def put(conv: str, bn: str, parts, v):
        if parts[-2] == "convolution":
            out[f"{conv}.weight"] = _t(v)
        elif parts[-1] in _BN_FIELDS:
            out[f"{bn}.{parts[-1]}"] = _t(v)

    for key, v in state_dict.items():
        parts = key.split(".")
        if key.startswith("embedder."):
            put("conv1", "bn1", parts, v)
        elif key.startswith("encoder.stages."):
            mod = f"layer{int(parts[2]) + 1}.{int(parts[4])}"
            if parts[5] == "shortcut":
                put(f"{mod}.downsample.0", f"{mod}.downsample.1", parts, v)
            elif parts[5] == "layer":
                i = int(parts[6]) + 1
                put(f"{mod}.conv{i}", f"{mod}.bn{i}", parts, v)
    for key in [k for k in out if k.endswith(".running_var")]:
        out.setdefault(key.replace("running_var", "num_batches_tracked"),
                       torch.tensor(0, dtype=torch.long))
    return out


def convert_hf_seq2seq(state_dict: Dict[str, Any], cfg) -> StateDict:
    """An HF Pegasus / BART / BigBirdPegasus ForConditionalGeneration state
    dict -> the port `Seq2Seq(cfg)`'s state dict (JAX
    models/seq2seq.py:780-856): Pegasus and BART keys are the port's; a
    layer with `self_attn.self.query` (BigBirdPegasus) has
    self.{query,key,value} and output renamed to {q,k,v,out}_proj, and
    where cfg.pre_norm and the dict has no `model.encoder.layer_norm`,
    BigBirdPegasus's final LayerNorms `model.{encoder,decoder}.
    layernorm_embedding` become `layer_norm` (BART's embedding LayerNorm of
    that name is a post-norm model's, left as it is). final_logits_bias is
    zeros where the dict has none. Keys the port's model lacks (lm_head,
    embed_tokens: both tied to model.shared) are left."""
    from .seq2seq import Seq2Seq

    rename: Dict[str, str] = {}
    for side, n_layers in (("encoder", cfg.encoder_layers),
                           ("decoder", cfg.decoder_layers)):
        for i in range(n_layers):
            hf = f"model.{side}.layers.{i}.self_attn"
            if f"{hf}.self.query.weight" not in state_dict:
                continue
            for hf_n, ours in (("self.query", "q_proj"),
                               ("self.key", "k_proj"),
                               ("self.value", "v_proj"),
                               ("output", "out_proj")):
                for leaf in ("weight", "bias"):
                    rename[f"{hf}.{hf_n}.{leaf}"] = f"{hf}.{ours}.{leaf}"
    if cfg.pre_norm and "model.encoder.layer_norm.weight" not in state_dict:
        for side in ("encoder", "decoder"):
            for leaf in ("weight", "bias"):
                rename[f"model.{side}.layernorm_embedding.{leaf}"] = \
                    f"model.{side}.layer_norm.{leaf}"
    sd = {rename.get(k, k): v for k, v in state_dict.items()}
    with torch.device("meta"):
        keys = Seq2Seq(cfg).state_dict().keys()
    out = {k: _t(sd[k]) for k in keys if k != "final_logits_bias"}
    out["final_logits_bias"] = (
        _t(sd["final_logits_bias"]).reshape(1, -1)
        if "final_logits_bias" in sd
        else torch.zeros(1, cfg.vocab_size))
    return out
