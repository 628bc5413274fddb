"""Weights carried across from the JAX package's parameter trees.

Each model has one table of (JAX tree path, port state-dict key, kind)
entries; kind says how a leaf changes layout:

- "dense": flax Dense kernel [in, out] <-> torch Linear weight [out, in];
- "conv": flax Conv kernel HWIO <-> torch Conv2d weight OIHW;
- "copy": same layout (embeddings, norms, biases, BN statistics);
- "row": a flat vector <-> a [1, n] buffer (final_logits_bias).

`from_jax` turns a tree of numpy arrays into a state dict (float leaves
as float32, int8 leaves as they are), and
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
        a = np.asarray(_get(tree, path))
        if a.dtype != np.int8:
            a = a.astype(np.float32, copy=False)
        # np.array copies: the state dict owns writable, contiguous memory
        sd[key] = torch.from_numpy(np.array(_to_torch_layout(a, kind)))
    return sd


def random_jax_tree(model: torch.nn.Module, entries: Sequence[Entry],
                    seed: int = 0) -> dict:
    """A seeded random tree in the JAX layout with `model`'s shapes.
    Kernels and embeddings ~ N(0, 1/fan_in) (flax's lecun-normal scale),
    the window attention's position bias ~ N(0, 0.02^2) (its flax init),
    norm and BN scales and variances 1, biases and means 0."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tree: dict = {}
    for path, key, kind in entries:
        shape = _to_jax_layout(np.empty(shapes[key], np.float32), kind).shape
        leaf = path[-1]
        if leaf in ("kernel", "embedding") or leaf.endswith("_kernel"):
            if leaf == "embedding":
                fan_in = shape[-1]
            elif len(shape) == 3:  # a stacked Dense: [W, in, out]
                fan_in = shape[1]
            else:
                fan_in = int(np.prod(shape[:-1]))
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(1.0 / np.sqrt(fan_in))
        elif leaf == "window_pos_bias":  # flax normal(0.02)
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
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


def bert_for_chapter_entries(num_layers: int,
                             pretrain_stage: bool = False) -> List[Entry]:
    """BertForChapter params {base_model, head} <-> port keys: the chapter
    head (kernel and bias), or the bias-free MLM head with
    pretrain_stage."""
    return ([(("params", "base_model", *p), f"base_model.{k}", kind)
             for p, k, kind in bert_entries(num_layers)]
            + _dense(("params", "head"), "head", bias=not pretrain_stage))


def _self_attention(jax_path, key) -> List[Entry]:
    """SelfAttentionHead (models/fusion.py:110): query, key, value, proj."""
    return [e for name in ("query", "key", "value", "proj")
            for e in _dense((*jax_path, name), f"{key}.{name}")]


def chapter_head_entries(head_type: str = "mlp") -> List[Entry]:
    """ChapterHead params (mlp or attn) <-> the reference's two_stream.py
    keys."""
    head = (_dense(("head",), "head") if head_type == "mlp"
            else _self_attention(("head",), "head"))
    return (_dense(("lang_proj_head",), "lang_proj_head", bias=False)
            + _dense(("vision_proj_head",), "vision_proj_head", bias=False)
            + head)


def _streams(num_bert_layers, stage_sizes) -> List[Entry]:
    out = [(("params", "lang_model", *p), f"lang_model.{k}", kind)
           for p, k, kind in bert_entries(num_bert_layers)]
    out += [((p[0], "vision_model", *p[1:]), f"vision_model.{k}", kind)
            for p, k, kind in resnet_entries(stage_sizes)]
    return out


def two_stream_entries(num_bert_layers: int, stage_sizes: Sequence[int],
                       head_type: str = "mlp") -> List[Entry]:
    """TwoStream variables {params: {lang_model, vision_model,
    fusion_head}, batch_stats: {vision_model}} <-> port keys."""
    return _streams(num_bert_layers, stage_sizes) + [
        (("params", "fusion_head", *p), f"fusion_head.{k}", kind)
        for p, k, kind in chapter_head_entries(head_type)]


def _stacked_mlp(jax_path, key, n: int) -> List[Entry]:
    """StackedMLP: dense{i} ([W, in, out] kernels, same layout) and ln{i}."""
    out: List[Entry] = []
    for i in range(n):
        out += [((*jax_path, f"dense{i}", "kernel"), f"{key}.dense{i}.weight",
                 "copy"),
                ((*jax_path, f"dense{i}", "bias"), f"{key}.dense{i}.bias",
                 "copy")]
        if i < n - 1:
            out += _ln((*jax_path, f"ln{i}"), f"{key}.ln{i}")
    return out


def window_head_entries(head_type: str = "mlp") -> List[Entry]:
    """WindowChapterHead params of one head type (models/fusion.py:269)."""
    out = (_stacked_mlp(("lang_proj_heads",), "lang_proj_heads", 2)
           + _stacked_mlp(("vision_proj_heads",), "vision_proj_heads", 3))
    if head_type == "mlp":
        return out + _stacked_mlp(("head",), "head", 3)
    if head_type == "bilinear":
        return out + [(("bilinear_kernel",), "bilinear_kernel", "copy"),
                      (("bilinear_bias",), "bilinear_bias", "copy")] \
            + _ln(("head_ln_in",), "head_ln_in") \
            + _stacked_mlp(("head",), "head", 2)
    if head_type == "multiplication":
        return out + _stacked_mlp(("lang_expand_layers",),
                                  "lang_expand_layers", 2) \
            + _ln(("lang_expand_ln",), "lang_expand_ln") \
            + _stacked_mlp(("head",), "head", 3)
    if head_type == "self_attn":
        return out + _self_attention(("head",), "head")
    if head_type == "cross_attn":
        out += _ln(("head", "lang_norm"), "head.lang_norm")
        out += _ln(("head", "vision_norm"), "head.vision_norm")
        for name in ("frame_pos_encoding", "query_proj", "key_proj",
                     "value_proj", "out_proj"):
            out += _dense(("head", name), f"head.{name}")
        return out
    raise ValueError(f"unknown head_type {head_type}")


def window_attention_entries(num_layers: int = 6) -> List[Entry]:
    """StackedWindowAttention params (models/fusion.py:373-465)."""
    out: List[Entry] = []
    for i in range(num_layers):
        b = f"block{i}"
        out += _ln((b, "attention_norm"), f"{b}.attention_norm")
        for name in ("position_encoding", "query", "key", "value"):
            out += _dense((b, name), f"{b}.{name}")
        out.append(((b, "window_pos_bias"), f"{b}.window_pos_bias", "copy"))
        out += _dense((b, "out_proj"), f"{b}.out_proj")
        out += _ln((b, "ffn_norm"), f"{b}.ffn_norm")
        for k in range(4):
            out += _dense((b, f"ffn{k}"), f"{b}.ffn{k}")
    out += _ln(("final_layer_norm",), "final_layer_norm")
    for k in range(4):
        out += _dense((f"cls{k}",), f"cls{k}")
        out += _ln((f"cls_ln{k}",), f"cls_ln{k}")
    return out + _dense(("classifier",), "classifier")


def two_stream_window_entries(num_bert_layers: int,
                              stage_sizes: Sequence[int],
                              head_type: str = "mlp") -> List[Entry]:
    """TwoStreamWindow variables {params: {lang_model, vision_model,
    fusion_head, window_attn}, batch_stats: {vision_model}} <-> port
    keys."""
    out = _streams(num_bert_layers, stage_sizes)
    out += [(("params", "fusion_head", *p), f"fusion_head.{k}", kind)
            for p, k, kind in window_head_entries(head_type)]
    return out + [(("params", "window_attn", *p), f"window_attn.{k}", kind)
                  for p, k, kind in window_attention_entries()]


def ds_window_attention_entries() -> List[Entry]:
    """DSWindowSelfAttention params (models/fusion_variants.py:26-87) <->
    port keys."""
    out = _dense(("position_encoding",), "position_encoding")
    out += _ln(("position_ln",), "position_ln") + _ln(("norm",), "norm")
    for name in ("query_proj", "key_proj", "value_proj"):
        out += _dense((name,), name)
    out.append((("window_pos_bias",), "window_pos_bias", "copy"))
    for i in range(3):
        out += _dense((f"out{i}",), f"out{i}")
        out += _ln((f"out_ln{i}",), f"out_ln{i}")
    return out + _dense(("out_final",), "out_final")


def domain_specific_head_entries() -> List[Entry]:
    """DomainSpecificChapterHead params (models/fusion_variants.py:90-140)
    <-> port keys."""
    out = (_stacked_mlp(("lang_proj_heads",), "lang_proj_heads", 2)
           + _stacked_mlp(("vision_proj_heads",), "vision_proj_heads", 3))
    for name in ("lang_window_attn", "vision_window_attn"):
        out += [((name, *p), f"{name}.{k}", kind)
                for p, k, kind in ds_window_attention_entries()]
    for i in range(4):
        out += _dense((f"cls{i}",), f"cls{i}")
        out += _ln((f"cls_ln{i}",), f"cls_ln{i}")
    return out + _dense(("classifier",), "classifier")


def two_stream_domain_specific_entries(num_bert_layers: int,
                                       stage_sizes: Sequence[int]
                                       ) -> List[Entry]:
    """TwoStreamDomainSpecific variables {params: {lang_model,
    vision_model, fusion_head}, batch_stats: {vision_model}} <-> port
    keys."""
    return _streams(num_bert_layers, stage_sizes) + [
        (("params", "fusion_head", *p), f"fusion_head.{k}", kind)
        for p, k, kind in domain_specific_head_entries()]


def single_block_window_entries() -> List[Entry]:
    """SingleBlockWindowClassifier params (models/fusion_variants.py:
    187-244) <-> port keys."""
    out = _ln(("attention_norm",), "attention_norm")
    for name in ("position_encoding", "query", "key", "value"):
        out += _dense((name,), name)
    out.append((("window_pos_bias",), "window_pos_bias", "copy"))
    out += _dense(("out_proj",), "out_proj")
    out += _ln(("ffn_norm",), "ffn_norm")
    out += _dense(("ffn_fc1",), "ffn_fc1") + _dense(("ffn_fc2",), "ffn_fc2")
    out += _ln(("cls_ln",), "cls_ln")
    return out + _dense(("cls_fc1",), "cls_fc1") + _dense(("cls_fc2",),
                                                            "cls_fc2")


def _dense_q(jax_path, key, bias=True) -> List[Entry]:
    """A weight-only int8 Dense (ops/quantize.py:quantize_seq2seq of the
    JAX package: kernel_q [in, out] and scale [out])."""
    out = [((*jax_path, "kernel_q"), f"{key}.weight_q", "dense"),
           ((*jax_path, "scale"), f"{key}.scale", "copy")]
    if bias:
        out.append(((*jax_path, "bias"), f"{key}.bias", "copy"))
    return out


def seq2seq_entries(cfg) -> List[Entry]:
    """Seq2Seq params <-> HuggingFace Pegasus/BART keys, following the
    config: attention biases only with cfg.attention_bias, final
    LayerNorms only with cfg.pre_norm, learned position tables
    (enc_pos/dec_pos <-> model.{side}.embed_positions) and embedding
    LayerNorms (enc_embed_ln/dec_embed_ln <-> model.{side}.
    layernorm_embedding) where the config has them. With cfg.weight_quant
    the int8 tree of quantize_seq2seq (kernel_q/scale, embedding_q/scale)
    <-> the port's Int8Linear/Int8Embed keys."""
    if cfg.weight_quant:
        dense = _dense_q
        out = [(("shared", "embedding_q"), "model.shared.embedding_q", "copy"),
               (("shared", "scale"), "model.shared.scale", "copy")]
    else:
        dense = _dense
        out = [(("shared", "embedding"), "model.shared.weight", "copy")]
    for side, n_layers in (("encoder", cfg.encoder_layers),
                           ("decoder", cfg.decoder_layers)):
        short = "enc" if side == "encoder" else "dec"
        if cfg.learned_positions:
            out.append(((f"{short}_pos", "embedding"),
                        f"model.{side}.embed_positions.weight", "copy"))
        if cfg.embed_layernorm:
            out += _ln((f"{short}_embed_ln",),
                       f"model.{side}.layernorm_embedding")
        for i in range(n_layers):
            fl, hf = f"{short}_layer{i}", f"model.{side}.layers.{i}"
            attns = ["self_attn"] + (["encoder_attn"] if side == "decoder"
                                     else [])
            for attn in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    out += dense((fl, attn, proj), f"{hf}.{attn}.{proj}",
                                 bias=cfg.attention_bias)
                out += _ln((fl, f"{attn}_layer_norm"),
                           f"{hf}.{attn}_layer_norm")
            out += dense((fl, "ffn", "fc1"), f"{hf}.fc1")
            out += dense((fl, "ffn", "fc2"), f"{hf}.fc2")
            out += _ln((fl, "final_layer_norm"), f"{hf}.final_layer_norm")
        if cfg.pre_norm:
            out += _ln((f"{side}_ln",), f"model.{side}.layer_norm")
    out.append((("final_logits_bias",), "final_logits_bias", "row"))
    return out


def vision_title_entries(cfg, fusion_type: str = "cross_attn"
                         ) -> List[Entry]:
    """Seq2SeqVisionEmb params {"seq2seq": ..., "fusion_head": ...} <->
    the port's keys: seq2seq_entries under `seq2seq` (so the state dict
    without its `seq2seq.` prefix is the title layout convert_hf_seq2seq
    reads; int8 with cfg.weight_quant) and the fusion head's bias-free
    projections, then its Linear ("mlp") or its cross attention's query,
    key, value and proj ("cross_attn"), which stay float under
    weight_quant (JAX ops/quantize.py:quantize_seq2seq transforms only
    the Seq2Seq core)."""
    out = [(("seq2seq", *path), f"seq2seq.{key}", kind)
           for path, key, kind in seq2seq_entries(cfg)]
    head = ("fusion_head",)
    out += _dense((*head, "lang_proj_head"), "fusion_head.lang_proj_head",
                  bias=False)
    out += _dense((*head, "vision_proj_head"),
                  "fusion_head.vision_proj_head", bias=False)
    if fusion_type == "mlp":
        out += _dense((*head, "fusion_head"), "fusion_head.fusion_head",
                      bias=False)
    else:
        for name in ("query", "key", "value", "proj"):
            out += _dense((*head, "fusion_head", name),
                          f"fusion_head.fusion_head.{name}")
    return out


# ---------------------------------------------------------------------------
# per-model converters
# ---------------------------------------------------------------------------


def gpt_entries(cfg) -> List[Entry]:
    """GPT params (models/gpt.py; JAX models/gpt.py) <-> port keys: the
    token embedding (not with using_pretrained_embed), the learnable
    positions (not with the fixed sinusoid), each block's norms,
    attention and MLP, ln_f and the bias-free head."""
    out: List[Entry] = []
    if not cfg.using_pretrained_embed:
        out.append((("params", "tok_emb", "embedding"), "tok_emb.weight",
                    "copy"))
    if cfg.learnable_pos_emb:
        out.append((("params", "pos_emb"), "pos_emb", "copy"))
    for i in range(cfg.n_layer):
        fl, pb = ("params", f"block{i}"), f"blocks.{i}"
        out += _ln((*fl, "ln1"), f"{pb}.ln1") + _ln((*fl, "ln2"), f"{pb}.ln2")
        for name in ("query", "key", "value", "proj"):
            out += _dense((*fl, "attn", name), f"{pb}.attn.{name}")
        out += _dense((*fl, "mlp_fc"), f"{pb}.mlp_fc")
        out += _dense((*fl, "mlp_proj"), f"{pb}.mlp_proj")
    return (out + _ln(("params", "ln_f"), "ln_f")
            + _dense(("params", "head"), "head", bias=False))


def listwise_bert_entries(num_layers: int) -> List[Entry]:
    """ListwiseBert variables {bert, head} (JAX models/contrastive.py:
    119-136) <-> port keys bert.* and head.*."""
    return ([(("bert", *p), f"bert.{k}", kind)
             for p, k, kind in bert_entries(num_layers)]
            + _dense(("head",), "head"))


def moco_entries(num_layers: int) -> List[Entry]:
    """A MoCoState's params_q, params_k and queue (JAX
    models/contrastive.py:30-34) <-> MoCoTextEncoder's encoder_q.*,
    encoder_k.* and queue (the pointer: from_jax_moco)."""
    out: List[Entry] = []
    for side in "qk":
        out += [((f"params_{side}", *p), f"encoder_{side}.{k}", kind)
                for p, k, kind in bert_entries(num_layers)]
    return out + [(("queue",), "queue", "copy")]


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


def from_jax_chapter_head(params, head_type: str = "mlp"):
    return from_jax(params, chapter_head_entries(head_type))


def from_jax_two_stream(variables, num_bert_layers: int,
                        stage_sizes: Sequence[int], head_type: str = "mlp"):
    """TwoStream {params, batch_stats} -> the port's full state dict
    (parameters and BatchNorm statistics)."""
    return _with_bn_counters(from_jax(
        variables, two_stream_entries(num_bert_layers, stage_sizes,
                                      head_type)))


def from_jax_two_stream_window(variables, num_bert_layers: int,
                               stage_sizes: Sequence[int],
                               head_type: str = "mlp"):
    """TwoStreamWindow {params, batch_stats} -> the port's full state
    dict."""
    return _with_bn_counters(from_jax(
        variables, two_stream_window_entries(num_bert_layers, stage_sizes,
                                             head_type)))


def from_jax_two_stream_domain_specific(variables, num_bert_layers: int,
                                        stage_sizes: Sequence[int]):
    """TwoStreamDomainSpecific {params, batch_stats} -> the port's full
    state dict."""
    return _with_bn_counters(from_jax(
        variables, two_stream_domain_specific_entries(num_bert_layers,
                                                      stage_sizes)))


def from_jax_single_block_window(params):
    """SingleBlockWindowClassifier params -> the port's state dict."""
    return from_jax(params, single_block_window_entries())


def from_jax_seq2seq(params, cfg):
    """Seq2Seq params -> state dict; an int8 tree (the JAX package's
    quantize_seq2seq) with cfg.weight_quant."""
    return from_jax(params, seq2seq_entries(cfg))


def act_scales_from_jax(quant) -> Dict[str, torch.Tensor]:
    """The JAX ResNet's "quant" collection ({"layer2_block1":
    {"act_scales": [4]}, ...}) -> the port ResNet's act_scales
    ({"layer2.1": float32 [4]})."""
    out = {}
    for name, leaf in quant.items():
        stage, block = name[len("layer"):].split("_block")
        out[f"layer{stage}.{block}"] = torch.from_numpy(
            np.array(leaf["act_scales"], dtype=np.float32))
    return out


def from_jax_moco(state, num_layers: int) -> Dict[str, torch.Tensor]:
    """A JAX MoCoState (its fields, or a dict of them) -> MoCoTextEncoder's
    state dict, queue_ptr an int64 scalar."""
    tree = {k: (state[k] if isinstance(state, dict) else getattr(state, k))
            for k in ("params_q", "params_k", "queue", "queue_ptr")}
    sd = from_jax(tree, moco_entries(num_layers))
    sd["queue_ptr"] = torch.tensor(int(np.asarray(tree["queue_ptr"])))
    return sd


def from_jax_listwise_bert(variables, num_layers: int
                           ) -> Dict[str, torch.Tensor]:
    """ListwiseBert variables {bert, head} -> the port's state dict."""
    return from_jax(variables, listwise_bert_entries(num_layers))
