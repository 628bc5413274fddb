"""Weights carried across from the JAX package's parameter trees.

Each model has one table of (JAX tree path, port state-dict key, kind)
entries; kind says how a leaf changes layout:

- "dense": flax Dense kernel [in, out] <-> torch Linear weight [out, in];
- "conv": flax Conv kernel HWIO <-> torch Conv2d weight OIHW;
- "copy": same layout (embeddings, norms, biases, BN statistics);
- "row": a flat vector <-> a [1, n] buffer (final_logits_bias).

`from_jax` turns a tree of numpy arrays into a state dict, and
`random_jax_tree` draws a seeded random tree in the JAX layout with the
shapes of a port model (chip_smoke.py serves full-width models from it).
The opposite direction needs no code here: the port's state dicts carry
torchvision / HuggingFace / reference key names, which the JAX package's
own converters read. Trees are nested dicts, as flax returns them; the
`variables` of a model hold "params" and, for BatchNorm, "batch_stats".
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Entry = Tuple[Tuple[str, ...], str, str]


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _put(tree, path, leaf):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


def _to_torch_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return a.T
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "row":
        return a.reshape(1, -1)
    return a


def _to_jax_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return a.T
    if kind == "conv":
        return a.transpose(2, 3, 1, 0)
    if kind == "row":
        return a.reshape(-1)
    return a


def from_jax(tree, entries: Sequence[Entry]) -> Dict[str, torch.Tensor]:
    """JAX-layout tree (numpy or array-like leaves) -> port state dict."""
    sd = {}
    for path, key, kind in entries:
        a = np.asarray(_get(tree, path), dtype=np.float32)
        # np.array copies: the state dict owns writable, contiguous memory
        sd[key] = torch.from_numpy(np.array(_to_torch_layout(a, kind)))
    return sd


def random_jax_tree(model: torch.nn.Module, entries: Sequence[Entry],
                    seed: int = 0) -> dict:
    """A seeded random tree in the JAX layout with `model`'s shapes.
    Kernels and embeddings ~ N(0, 1/fan_in) (flax's lecun-normal scale),
    norm and BN scales and variances 1, biases and means 0."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tree: dict = {}
    for path, key, kind in entries:
        shape = _to_jax_layout(np.empty(shapes[key], np.float32), kind).shape
        leaf = path[-1]
        if leaf in ("kernel", "embedding"):
            fan_in = shape[-1] if leaf == "embedding" else int(np.prod(shape[:-1]))
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(1.0 / np.sqrt(fan_in))
        elif leaf in ("scale", "var"):
            a = np.ones(shape, np.float32)
        else:  # bias, mean, final_logits_bias
            a = np.zeros(shape, np.float32)
        _put(tree, path, a)
    return tree


# ---------------------------------------------------------------------------
# entry tables
# ---------------------------------------------------------------------------


def _bn(jax_path, key) -> List[Entry]:
    """A BatchNorm: scale/bias in params, mean/var in batch_stats."""
    return [(("params", *jax_path, "scale"), f"{key}.weight", "copy"),
            (("params", *jax_path, "bias"), f"{key}.bias", "copy"),
            (("batch_stats", *jax_path, "mean"), f"{key}.running_mean", "copy"),
            (("batch_stats", *jax_path, "var"), f"{key}.running_var", "copy")]


def resnet_entries(stage_sizes: Sequence[int]) -> List[Entry]:
    """ResNet variables {params, batch_stats} <-> torchvision keys."""
    out = [(("params", "conv_init", "kernel"), "conv1.weight", "conv")]
    out += _bn(("bn_init",), "bn1")
    for s, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            mod, key = f"layer{s + 1}_block{b}", f"layer{s + 1}.{b}"
            for k in (1, 2, 3):
                out.append((("params", mod, f"conv{k}", "kernel"),
                            f"{key}.conv{k}.weight", "conv"))
                out += _bn((mod, f"bn{k}"), f"{key}.bn{k}")
            if b == 0:
                out.append((("params", mod, "proj_conv", "kernel"),
                            f"{key}.downsample.0.weight", "conv"))
                out += _bn((mod, "proj_bn"), f"{key}.downsample.1")
    return out


def _dense(jax_path, key, bias=True) -> List[Entry]:
    out = [((*jax_path, "kernel"), f"{key}.weight", "dense")]
    if bias:
        out.append(((*jax_path, "bias"), f"{key}.bias", "copy"))
    return out


def _ln(jax_path, key) -> List[Entry]:
    return [((*jax_path, "scale"), f"{key}.weight", "copy"),
            ((*jax_path, "bias"), f"{key}.bias", "copy")]


def bert_entries(num_layers: int) -> List[Entry]:
    """BertModel params <-> HuggingFace BertModel keys."""
    out = [(("word_embeddings", "embedding"),
            "embeddings.word_embeddings.weight", "copy"),
           (("position_embeddings", "embedding"),
            "embeddings.position_embeddings.weight", "copy"),
           (("token_type_embeddings", "embedding"),
            "embeddings.token_type_embeddings.weight", "copy")]
    out += _ln(("embeddings_ln",), "embeddings.LayerNorm")
    for i in range(num_layers):
        fl, hf = f"layer{i}", f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            out += _dense((fl, "attention", name),
                          f"{hf}.attention.self.{name}")
        out += _dense((fl, "attention", "out"), f"{hf}.attention.output.dense")
        out += _ln((fl, "attention", "out_ln"),
                   f"{hf}.attention.output.LayerNorm")
        out += _dense((fl, "intermediate"), f"{hf}.intermediate.dense")
        out += _dense((fl, "output"), f"{hf}.output.dense")
        out += _ln((fl, "output_ln"), f"{hf}.output.LayerNorm")
    out += _dense(("pooler",), "pooler.dense")
    return out


def chapter_head_entries() -> List[Entry]:
    """mlp ChapterHead params <-> the reference's two_stream.py keys."""
    return (_dense(("lang_proj_head",), "lang_proj_head", bias=False)
            + _dense(("vision_proj_head",), "vision_proj_head", bias=False)
            + _dense(("head",), "head"))


def two_stream_entries(num_bert_layers: int,
                       stage_sizes: Sequence[int]) -> List[Entry]:
    """TwoStream variables {params: {lang_model, vision_model,
    fusion_head}, batch_stats: {vision_model}} <-> port keys."""
    out = [(("params", "lang_model", *p), f"lang_model.{k}", kind)
           for p, k, kind in bert_entries(num_bert_layers)]
    out += [((p[0], "vision_model", *p[1:]), f"vision_model.{k}", kind)
            for p, k, kind in resnet_entries(stage_sizes)]
    out += [(("params", "fusion_head", *p), f"fusion_head.{k}", kind)
            for p, k, kind in chapter_head_entries()]
    return out


def seq2seq_entries(cfg) -> List[Entry]:
    """Pegasus Seq2Seq params <-> HuggingFace Pegasus keys."""
    out = [(("shared", "embedding"), "model.shared.weight", "copy")]
    for side, n_layers in (("encoder", cfg.encoder_layers),
                           ("decoder", cfg.decoder_layers)):
        short = "enc" if side == "encoder" else "dec"
        for i in range(n_layers):
            fl, hf = f"{short}_layer{i}", f"model.{side}.layers.{i}"
            attns = ["self_attn"] + (["encoder_attn"] if side == "decoder"
                                     else [])
            for attn in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    out += _dense((fl, attn, proj), f"{hf}.{attn}.{proj}")
                out += _ln((fl, f"{attn}_layer_norm"),
                           f"{hf}.{attn}_layer_norm")
            out += _dense((fl, "ffn", "fc1"), f"{hf}.fc1")
            out += _dense((fl, "ffn", "fc2"), f"{hf}.fc2")
            out += _ln((fl, "final_layer_norm"), f"{hf}.final_layer_norm")
        out += _ln((f"{side}_ln",), f"model.{side}.layer_norm")
    out.append((("final_logits_bias",), "final_logits_bias", "row"))
    return out


# ---------------------------------------------------------------------------
# per-model converters
# ---------------------------------------------------------------------------


def _with_bn_counters(sd):
    """torch BatchNorm state dicts also hold num_batches_tracked."""
    for key in [k for k in sd if k.endswith(".running_var")]:
        sd[key.replace("running_var", "num_batches_tracked")] = \
            torch.tensor(0, dtype=torch.long)
    return sd


def from_jax_resnet(variables, stage_sizes: Sequence[int]):
    """ResNet {params, batch_stats} -> torchvision-keyed state dict."""
    return _with_bn_counters(from_jax(variables, resnet_entries(stage_sizes)))


def from_jax_bert(params, num_layers: int):
    return from_jax(params, bert_entries(num_layers))


def from_jax_chapter_head(params):
    return from_jax(params, chapter_head_entries())


def from_jax_two_stream(variables, num_bert_layers: int,
                        stage_sizes: Sequence[int]):
    """TwoStream {params, batch_stats} -> the port's full state dict
    (parameters and BatchNorm statistics)."""
    return _with_bn_counters(from_jax(
        variables, two_stream_entries(num_bert_layers, stage_sizes)))


def from_jax_seq2seq(params, cfg):
    return from_jax(params, seq2seq_entries(cfg))
