"""Weight conversion and tokenizer export on the port against the JAX
package's, on the CPU (no reference checkout: the reference-layout
checkpoints are made from seeded arrays with the reference's key names).

- models/convert_reference.py: the whole TwoStreamWindow (mlp and
  cross_attn heads) and the base ChapterHead (mlp and attn) against the
  JAX converters carried into the port's layout (models/convert.py),
  bit for bit, and two_stream_window_to_reference gives the reference
  dict back; the result loads into the port's model with strict=True.
- cli/convert_weights for every kind: resnet50 (fc and "module."
  prefixes present), bert ("base_model.", position_ids), pegasus and bart
  (tiny, with HF's extra tables) and two_stream_window ({"model_state_dict":
  ...}): the written state dict bit for bit the JAX converter's, carried
  over, and the printed parameter count the JAX CLI's where the JAX CLI
  takes the checkpoint.
- cli/export_tokenizer: WordPiece and Unigram tokenizer.json and a
  vocab.txt passthrough write the files the JAX CLI writes.
"""

import json

import numpy as np
import pytest
import torch

from video_chapter_generation_tpu.cli import convert_weights as jax_cli
from video_chapter_generation_tpu.cli import export_tokenizer as jax_export
from video_chapter_generation_tpu.models import convert_reference as jref
from video_chapter_generation_tpu.models.bert import convert_hf_bert
from video_chapter_generation_tpu.models.resnet import (
    convert_torchvision_resnet50,
)
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2SeqConfig as JaxSeq2SeqConfig,
    convert_hf_seq2seq,
)
from video_chapter_generation_tpu_torch.cli import (
    convert_weights,
    export_tokenizer,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models import convert_reference
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
)
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
)

SIZES, W, H, SEG, NH = (1, 1, 1, 1), 3, 32, 4, 16


def _fill(shapes, seed):
    """Seeded float32 tensors for {key: shape}; BN counters 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(0, dtype=torch.long)
        else:
            out[k] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))
    return out


def _shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _bert_shapes():
    with torch.device("meta"):
        return _shapes(BertModel(BertConfig.tiny()))


def _resnet_shapes():
    with torch.device("meta"):
        return _shapes(ResNet(50, stage_sizes=SIZES))


def _head_shapes(head_type):
    """A reference two_stream_window.py fusion_head, per position."""
    out = {}

    def seq(fmt, dims):  # Linear at 0, 4, 8 with LayerNorms after all but last
        for j, (a, b) in enumerate(zip(dims, dims[1:])):
            out[fmt.format(4 * j) + ".weight"] = (b, a)
            out[fmt.format(4 * j) + ".bias"] = (b,)
            if j < len(dims) - 2:
                out[fmt.format(4 * j + 1) + ".weight"] = (b,)
                out[fmt.format(4 * j + 1) + ".bias"] = (b,)

    for i in range(W):
        seq(f"lang_proj_heads.{i}.{{}}", (H, H // 2, H))
        seq(f"vision_proj_heads.{i}.{{}}", (2048, 8 * H, 4 * H, H))
        if head_type == "mlp":
            seq(f"head.{i}.{{}}", ((SEG + 1) * H, 8 * H, 4 * H, H))
    if head_type == "cross_attn":
        for k in ("lang_norm", "vision_norm"):
            out[f"head.{k}.weight"] = out[f"head.{k}.bias"] = (H,)
        out["head.frame_pos_encoding.weight"] = (H, 1)
        out["head.frame_pos_encoding.bias"] = (H,)
        for k in ("query_proj", "key_proj", "value_proj", "out_proj"):
            out[f"head.{k}.weight"], out[f"head.{k}.bias"] = (H, H), (H,)
    return out


def _window_attn_shapes():
    """stacked_window_self_attention.py's keys."""
    out = {}

    def lin(key, a, b):
        out[key + ".weight"], out[key + ".bias"] = (b, a), (b,)

    def ln(key, n):
        out[key + ".weight"] = out[key + ".bias"] = (n,)

    for i in range(6):
        p = f"layers.{i}"
        ln(f"{p}.attention_norm", H)
        ln(f"{p}.ffn_norm", H)
        lin(f"{p}.attention.position_encoding", 1, H)
        for k in ("query", "key", "value", "out_proj"):
            lin(f"{p}.attention.{k}", H, H)
        out[f"{p}.attention.window_pos_bias"] = (1, NH, 1, W)
        for idx, (a, b) in zip((0, 3, 6, 9), ((H, 2 * H), (2 * H, 4 * H),
                                              (4 * H, 2 * H), (2 * H, H))):
            lin(f"{p}.ffn.{idx}", a, b)
    ln("final_layer_norm", H)
    dims = (H, H, H, H // 2, H // 4)
    for j, idx in enumerate((0, 4, 8, 12)):
        lin(f"classifier.{idx}", dims[j], dims[j + 1])
        ln(f"classifier.{idx + 1}", dims[j + 1])
    lin("classifier.16", H // 4, 2)
    return out


def _reference_window(head_type, seed):
    """A reference TwoStreamWindow state dict (BERT tiny, ResNet (1, 1, 1,
    1) with its fc)."""
    shapes = {f"lang_model.base_model.{k}": v
              for k, v in _bert_shapes().items()}
    shapes["lang_model.base_model.embeddings.position_ids"] = (1, 64)
    shapes.update({f"vision_model.base_model.{k}": v
                   for k, v in _resnet_shapes().items()})
    shapes["vision_model.base_model.fc.weight"] = (10, 2048)
    shapes.update({f"fusion_head.{k}": v
                   for k, v in _head_shapes(head_type).items()})
    shapes.update({f"window_attn.{k}": v
                   for k, v in _window_attn_shapes().items()})
    return _fill(shapes, seed)


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("head_type", ["mlp", "cross_attn"])
def test_convert_two_stream_window_matches_jax(head_type):
    sd = _reference_window(head_type, 0)
    got = convert_reference.convert_two_stream_window(sd, 1, head_type)
    jax_vars = jref.convert_two_stream_window(sd, 1, head_type)
    want = convert.from_jax_two_stream_window(jax_vars, 2, SIZES, head_type)
    _same(got, want)
    back = convert_reference.two_stream_window_to_reference(got, head_type)
    _same(back, {k: v for k, v in sd.items()
                 if not k.endswith(("position_ids", "fc.weight"))})


@pytest.mark.parametrize("head_type", ["mlp", "attn"])
def test_convert_base_chapter_head_matches_jax(head_type):
    shapes = {"lang_proj_head.weight": (H, 24),
              "vision_proj_head.weight": (H, 40)}
    if head_type == "mlp":
        shapes.update({"head.weight": (2, (SEG + 1) * H), "head.bias": (2,)})
    else:
        for k, o in (("query", H), ("key", H), ("value", H), ("proj", 2)):
            shapes[f"head.{k}.weight"], shapes[f"head.{k}.bias"] = (o, H), (o,)
    sd = _fill(shapes, 1)
    _same(convert_reference.convert_base_chapter_head(sd, head_type),
          convert.from_jax_chapter_head(
              jref.convert_base_chapter_head(sd, head_type), head_type))


def _seq2seq_hf(kind, seed):
    """A tiny HF ForConditionalGeneration state dict with HF's extras (the
    tied lm_head and embed_tokens; Pegasus's sinusoid table)."""
    kw = ({} if kind == "pegasus" else dict(
        activation="gelu", pre_norm=False, learned_positions=True,
        position_offset=2, scale_embedding=False, embed_layernorm=True))
    with torch.device("meta"):
        shapes = _shapes(Seq2Seq(Seq2SeqConfig.tiny(max_positions=64, **kw)))
    shapes["lm_head.weight"] = shapes["model.shared.weight"]
    shapes["model.encoder.embed_tokens.weight"] = shapes["model.shared.weight"]
    if kind == "pegasus":
        shapes["model.encoder.embed_positions.weight"] = (64, 32)
    return _fill(shapes, seed), JaxSeq2SeqConfig.tiny(max_positions=64, **kw)


def _write(tmp_path, name, sd):
    path = tmp_path / name
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("kind", ["resnet50", "bert", "pegasus", "bart",
                                  "two_stream_window"])
def test_convert_weights_cli_matches_jax(tmp_path, capsys, kind):
    argv = []
    if kind == "resnet50":
        sd = _fill(dict(_resnet_shapes(), **{"fc.weight": (10, 2048)}), 2)
        ckpt = {f"module.{k}": v for k, v in sd.items()}
        want = convert.from_jax_resnet(convert_torchvision_resnet50(sd),
                                       SIZES)
    elif kind == "bert":
        sd = _fill(dict(_bert_shapes(), **{"embeddings.position_ids":
                                           (1, 64)}), 3)
        ckpt = {f"base_model.{k}": v for k, v in sd.items()}
        want = convert.from_jax_bert(convert_hf_bert(sd)["params"], 2)
    elif kind in ("pegasus", "bart"):
        ckpt, jcfg = _seq2seq_hf(kind, 4)
        want = convert.from_jax_seq2seq(
            convert_hf_seq2seq(ckpt, jcfg)["params"], jcfg)
    else:
        sd = _reference_window("mlp", 5)
        ckpt = {"model_state_dict": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3}
        want = convert.from_jax_two_stream_window(
            jref.convert_two_stream_window(sd, 1, "mlp"), 2, SIZES)
        argv = ["--window_size", "1", "--head_type", "mlp"]
    src = _write(tmp_path, "in.pth", ckpt)
    out = str(tmp_path / "out.pt")
    convert_weights.main(["--kind", kind, "--torch_ckpt", src, "--out", out]
                         + argv)
    said = capsys.readouterr().out
    got = torch.load(out, weights_only=True)
    if kind in ("pegasus", "bart"):  # the JAX tree has no BN counters
        _same(got, want)
    else:
        _same({k: v for k, v in got.items()
               if not k.endswith("num_batches_tracked")},
              {k: v for k, v in want.items()
               if not k.endswith("num_batches_tracked")})
    if kind not in ("pegasus", "bart"):  # its CLI converts at large sizes
        jax_cli.main(["--kind", kind, "--torch_ckpt", src, "--out",
                      str(tmp_path / "jax.msgpack")] + argv)
        jax_said = capsys.readouterr().out
        assert said.split()[1] == jax_said.split()[1]


def test_export_tokenizer_matches_jax(tmp_path):
    wordpiece = {"model": {"type": "WordPiece", "vocab": {
        "[PAD]": 0, "[UNK]": 1, "hello": 3, "##s": 2}}}
    unigram = {"model": {"type": "Unigram", "vocab": [
        ["<pad>", 0.0], ["▁hello", -1.5], ["h", -9.25]]}}
    (tmp_path / "vocab.txt").write_text("[PAD]\nhello\n")
    for name, data in (("wp.json", wordpiece), ("uni.json", unigram),
                       ("vocab.txt", None)):
        src = tmp_path / name
        if data is not None:
            src.write_text(json.dumps(data))
        a, b = tmp_path / f"port_{name}.out", tmp_path / f"jax_{name}.out"
        export_tokenizer.main(["--input", str(src), "--out", str(a)])
        jax_export.main(["--input", str(src), "--out", str(b)])
        assert a.read_bytes() == b.read_bytes()
    with pytest.raises(SystemExit):
        export_tokenizer.export(str(_write_json(tmp_path)), str(a))


def _write_json(tmp_path):
    path = tmp_path / "bpe.json"
    path.write_text(json.dumps({"model": {"type": "BPE"}}))
    return path
