"""Reference torch checkpoints -> the port's state dicts (counterpart of
the JAX package's models/convert_reference.py).

The reference keeps per-window-position ModuleLists and Sequential
indices; the port's stacked modules take what the JAX converter stacks:
a StackedDense weight is the [W, in, out] stack of the W Linear weights
transposed, its bias the [W, out] stack, a StackedLayerNorm's weight and
bias the [W, dim] stacks. The BERT and ResNet streams need no mapping
beyond their prefixes: the port's BertModel carries HuggingFace's names
and its ResNet torchvision's. Each function returns a state dict of
tensors keyed as the port's module, which the module loads with
strict=True (train_video_segment_ddp.py's {model_state_dict, ...} after
its "module." prefixes are stripped).

Covered, as in the JAX package (:64, 108, 139, 158):
- WindowChapterHead (two_stream_window.py), mlp and cross_attn heads;
- StackedWindowAttention (stacked_window_self_attention.py);
- the base TwoStream ChapterHead (two_stream.py:51-95);
- the whole TwoStreamWindow, and back: two_stream_window_to_reference
  writes a port TwoStreamWindow state dict in the reference's layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .convert import bert_entries, resnet_entries

StateDict = Dict[str, torch.Tensor]


def _t(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    return torch.from_numpy(np.array(v))


def _strip(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def _stacked_mlp(sd, fmt: str, n: int, idx, key: str, out: StateDict):
    """A reference Sequential per position (Linears at idx, each but the
    last followed by a LayerNorm) -> StackedMLP dense{j} / ln{j}.
    fmt like 'lang_proj_heads.{i}.{k}'."""
    for j, k in enumerate(idx):
        ws = [_t(sd[fmt.format(i=i, k=k) + ".weight"]).t() for i in range(n)]
        bs = [_t(sd[fmt.format(i=i, k=k) + ".bias"]) for i in range(n)]
        out[f"{key}.dense{j}.weight"] = torch.stack(ws).contiguous()
        out[f"{key}.dense{j}.bias"] = torch.stack(bs)
        if j < len(idx) - 1:
            for leaf in ("weight", "bias"):
                out[f"{key}.ln{j}.{leaf}"] = torch.stack(
                    [_t(sd[fmt.format(i=i, k=k + 1) + f".{leaf}"])
                     for i in range(n)])


def _copy(sd, ref_key: str, key: str, out: StateDict):
    """A Linear or LayerNorm whose layout is the port's: weight, and bias
    where the reference has one."""
    for leaf in ("weight", "bias"):
        if f"{ref_key}.{leaf}" in sd:
            out[f"{key}.{leaf}"] = _t(sd[f"{ref_key}.{leaf}"])


def convert_window_chapter_head(sd: Dict[str, Any], num_clips: int,
                                head_type: str = "mlp") -> StateDict:
    """fusion_head.* of two_stream_window.py -> WindowChapterHead.

    Sequential index map (torch -> port): 2-layer projection MLP 0 ->
    dense0, 1 -> ln0, 4 -> dense1; 3-layer 0 -> dense0, 1 -> ln0, 4 ->
    dense1, 5 -> ln1, 8 -> dense2."""
    out: StateDict = {}
    _stacked_mlp(sd, "lang_proj_heads.{i}.{k}", num_clips, (0, 4),
                 "lang_proj_heads", out)
    _stacked_mlp(sd, "vision_proj_heads.{i}.{k}", num_clips, (0, 4, 8),
                 "vision_proj_heads", out)
    if head_type == "mlp":
        _stacked_mlp(sd, "head.{i}.{k}", num_clips, (0, 4, 8), "head", out)
    elif head_type == "cross_attn":
        for name in ("lang_norm", "vision_norm", "frame_pos_encoding",
                     "query_proj", "key_proj", "value_proj", "out_proj"):
            _copy(sd, f"head.{name}", f"head.{name}", out)
    else:
        raise NotImplementedError(head_type)
    return out


def convert_stacked_window_attention(sd: Dict[str, Any],
                                     num_layers: int = 6) -> StateDict:
    """window_attn.* (stacked_window_self_attention.py) ->
    StackedWindowAttention."""
    out: StateDict = {}
    for i in range(num_layers):
        ref, b = f"layers.{i}", f"block{i}"
        _copy(sd, f"{ref}.attention_norm", f"{b}.attention_norm", out)
        _copy(sd, f"{ref}.ffn_norm", f"{b}.ffn_norm", out)
        for name in ("position_encoding", "query", "key", "value",
                     "out_proj"):
            _copy(sd, f"{ref}.attention.{name}", f"{b}.{name}", out)
        out[f"{b}.window_pos_bias"] = _t(
            sd[f"{ref}.attention.window_pos_bias"])
        # ffn Sequential: Linears at 0, 3, 6, 9 -> ffn0..3
        for j, idx in enumerate((0, 3, 6, 9)):
            _copy(sd, f"{ref}.ffn.{idx}", f"{b}.ffn{j}", out)
    _copy(sd, "final_layer_norm", "final_layer_norm", out)
    # classifier Sequential: Linear / LayerNorm pairs at (0, 1), (4, 5),
    # (8, 9), (12, 13), the last Linear at 16
    for j, idx in enumerate((0, 4, 8, 12)):
        _copy(sd, f"classifier.{idx}", f"cls{j}", out)
        _copy(sd, f"classifier.{idx + 1}", f"cls_ln{j}", out)
    _copy(sd, "classifier.16", "classifier", out)
    return out


def convert_base_chapter_head(sd: Dict[str, Any],
                              head_type: str = "mlp") -> StateDict:
    """two_stream.py:51-95 ChapterHead -> the port's ChapterHead, whose
    names are the reference's: the bias-free projections and the Linear
    head (mlp) or the SelfAttention's query, key, value and proj (attn)."""
    out = {f"{k}.weight": _t(sd[f"{k}.weight"])
           for k in ("lang_proj_head", "vision_proj_head")}
    heads = ("head",) if head_type == "mlp" else tuple(
        f"head.{n}" for n in ("query", "key", "value", "proj"))
    for k in heads:
        _copy(sd, k, k, out)
    return out


def _count(sd, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def convert_bert(sd: Dict[str, Any]) -> StateDict:
    """A HuggingFace BertModel state dict -> the port's BertModel: the keys
    the port's model has, at every layer the dict holds (extra keys, as
    embeddings.position_ids, are left)."""
    n = _count(sd, "encoder.layer.{}.attention.self.query.weight")
    return {k: _t(sd[k]) for _, k, _ in bert_entries(n)}


def convert_resnet(sd: Dict[str, Any]) -> StateDict:
    """A torchvision ResNet state dict -> the port's ResNet (fc.* left; the
    reference replaces it with Identity, resnet50_tsm.py:19), the blocks
    per stage read off the keys; num_batches_tracked copied where present,
    else 0."""
    sizes = [_count(sd, f"layer{s}.{{}}.conv1.weight") for s in range(1, 5)]
    out = {k: _t(sd[k]) for _, k, _ in resnet_entries(sizes)}
    for key in [k for k in out if k.endswith(".running_var")]:
        counter = key.replace("running_var", "num_batches_tracked")
        out[counter] = (_t(sd[counter]) if counter in sd
                        else torch.tensor(0, dtype=torch.long))
    return out


def convert_two_stream_window(state_dict: Dict[str, Any], window_size: int,
                              head_type: str = "mlp") -> StateDict:
    """A whole reference TwoStreamWindow checkpoint -> the port's
    TwoStreamWindow state dict."""
    num_clips = 2 * window_size + 1
    parts = {
        "lang_model": convert_bert(_strip(state_dict,
                                          "lang_model.base_model.")),
        "vision_model": convert_resnet(_strip(state_dict,
                                              "vision_model.base_model.")),
        "fusion_head": convert_window_chapter_head(
            _strip(state_dict, "fusion_head."), num_clips, head_type),
        "window_attn": convert_stacked_window_attention(
            _strip(state_dict, "window_attn.")),
    }
    return {f"{prefix}.{k}": v for prefix, sd in parts.items()
            for k, v in sd.items()}


def _unstack_mlp(sd, key: str, fmt: str, idx, out: Dict[str, Any]):
    """StackedMLP dense{j} / ln{j} -> the reference's per-position
    Sequentials (the inverse of _stacked_mlp)."""
    n = sd[f"{key}.dense0.weight"].shape[0]
    for j, k in enumerate(idx):
        for i in range(n):
            out[fmt.format(i=i, k=k) + ".weight"] = \
                sd[f"{key}.dense{j}.weight"][i].t().contiguous()
            out[fmt.format(i=i, k=k) + ".bias"] = sd[f"{key}.dense{j}.bias"][i]
            if j < len(idx) - 1:
                for leaf in ("weight", "bias"):
                    out[fmt.format(i=i, k=k + 1) + f".{leaf}"] = \
                        sd[f"{key}.ln{j}.{leaf}"][i]


def two_stream_window_to_reference(sd: Dict[str, torch.Tensor],
                                   head_type: str = "mlp"
                                   ) -> Dict[str, torch.Tensor]:
    """The port's TwoStreamWindow state dict in the reference's layout, the
    inverse of convert_two_stream_window (two_stream_window.py's key
    names; what the reference's checkpoints hold under model_state_dict)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        for stream in ("lang_model.", "vision_model."):
            if k.startswith(stream):
                out[f"{stream}base_model.{k[len(stream):]}"] = v
    head = _strip(sd, "fusion_head.")
    _unstack_mlp(head, "lang_proj_heads",
                 "fusion_head.lang_proj_heads.{i}.{k}", (0, 4), out)
    _unstack_mlp(head, "vision_proj_heads",
                 "fusion_head.vision_proj_heads.{i}.{k}", (0, 4, 8), out)
    if head_type == "mlp":
        _unstack_mlp(head, "head", "fusion_head.head.{i}.{k}", (0, 4, 8), out)
    elif head_type == "cross_attn":
        out.update({f"fusion_head.{k}": v for k, v in head.items()
                    if k.startswith("head.")})
    else:
        raise NotImplementedError(head_type)
    renames = {"attention_norm": "attention_norm", "ffn_norm": "ffn_norm"}
    renames.update({n: f"attention.{n}" for n in (
        "position_encoding", "query", "key", "value", "out_proj",
        "window_pos_bias")})
    renames.update({f"ffn{j}": f"ffn.{idx}"
                    for j, idx in enumerate((0, 3, 6, 9))})
    top = {"final_layer_norm": "final_layer_norm", "classifier": "classifier.16"}
    top.update({f"cls{j}": f"classifier.{idx}"
                for j, idx in enumerate((0, 4, 8, 12))})
    top.update({f"cls_ln{j}": f"classifier.{idx + 1}"
                for j, idx in enumerate((0, 4, 8, 12))})
    for k, v in _strip(sd, "window_attn.").items():
        mod, leaf = k.split(".", 1) if "." in k else (k, "")
        if mod.startswith("block"):
            name, rest = leaf.split(".", 1) if "." in leaf else (leaf, "")
            ref = f"layers.{mod[len('block'):]}.{renames[name]}"
            out[f"window_attn.{ref}" + (f".{rest}" if rest else "")] = v
        else:
            out[f"window_attn.{top[mod]}.{leaf}"] = v
    return out
