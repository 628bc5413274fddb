"""Convert pretrained torch checkpoints into the port's state dicts
(counterpart of the JAX package's cli/convert_weights.py).

Supports:
- a torchvision resnet50 state dict          (--kind resnet50)
- a HuggingFace BertModel state dict         (--kind bert)
- HF Pegasus/BART ForConditionalGeneration   (--kind pegasus|bart;
  models/convert_hf.py:convert_hf_seq2seq)
- the reference's TwoStreamWindow checkpoint {model_state_dict, ...}
  (--kind two_stream_window --window_size N --head_type mlp|cross_attn)

    python -m video_chapter_generation_tpu_torch.cli.convert_weights \
        --kind bert --torch_ckpt bert.pth --out bert.pt

Strips DDP's "module." prefixes (and "base_model." for bert, pegasus and
bart) as the JAX CLI does. Where the JAX CLI writes a flax msgpack, this
writes a torch state dict (torch.save) that the port's model of that kind
loads with strict=True: ResNet(50), BertModel, Seq2Seq or TwoStreamWindow
(BERT-base widths there), each built at the sizes the checkpoint's
tensors give (vocabulary, width, layers, blocks per stage); the check is
made before the file is written. Prints the parameter count. Runs on the
host: no device is used.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import torch

KINDS = ("resnet50", "bert", "pegasus", "bart", "two_stream_window")


def _count(sd, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def _bert_config(sd):
    from ..models.bert import BertConfig

    vocab, h = sd["embeddings.word_embeddings.weight"].shape
    return BertConfig(
        vocab_size=vocab, hidden_size=h, num_heads=max(1, h // 64),
        num_layers=_count(sd, "encoder.layer.{}.attention.self.query.weight"),
        intermediate_size=sd[
            "encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_position_embeddings=sd[
            "embeddings.position_embeddings.weight"].shape[0],
        type_vocab_size=sd["embeddings.token_type_embeddings.weight"].shape[0])


def _seq2seq_config(kind: str, sd):
    from ..models.seq2seq import Seq2SeqConfig

    base = (Seq2SeqConfig.pegasus_large() if kind == "pegasus"
            else Seq2SeqConfig.bart_large())
    vocab, d = sd["model.shared.weight"].shape
    kw = dict(vocab_size=vocab, d_model=d, num_heads=max(1, d // 64),
              encoder_layers=_count(sd, "model.encoder.layers.{}.fc1.weight"),
              decoder_layers=_count(sd, "model.decoder.layers.{}.fc1.weight"),
              ffn_dim=sd["model.encoder.layers.0.fc1.weight"].shape[0])
    if base.learned_positions:
        kw["max_positions"] = (sd["model.encoder.embed_positions.weight"]
                               .shape[0] - base.position_offset)
    return dataclasses.replace(base, **kw)


def convert(kind: str, sd: Dict[str, torch.Tensor], window_size: int = 1,
            head_type: str = "mlp") -> Dict[str, torch.Tensor]:
    """A stripped torch state dict of `kind` -> the port's state dict,
    checked by a strict load into the port's model of that kind."""
    from ..models import convert_reference as ref
    from ..models.bert import BertModel
    from ..models.convert_hf import convert_hf_seq2seq
    from ..models.fusion import TwoStreamWindow
    from ..models.resnet import ResNet
    from ..models.seq2seq import Seq2Seq

    if kind == "resnet50":
        out = ref.convert_resnet(sd)
        sizes = [_count(out, f"layer{s}.{{}}.conv1.weight")
                 for s in range(1, 5)]
        build = lambda: ResNet(50, stage_sizes=sizes)  # noqa: E731
    elif kind == "bert":
        sd = {k.removeprefix("base_model."): v for k, v in sd.items()}
        out = ref.convert_bert(sd)
        build = lambda: BertModel(_bert_config(sd))  # noqa: E731
    elif kind in ("pegasus", "bart"):
        sd = {k.removeprefix("base_model."): v for k, v in sd.items()}
        cfg = _seq2seq_config(kind, sd)
        out = convert_hf_seq2seq(sd, cfg)
        build = lambda: Seq2Seq(cfg)  # noqa: E731
    else:
        out = ref.convert_two_stream_window(sd, window_size, head_type)
        bert_cfg = _bert_config(ref._strip(out, "lang_model."))
        sizes = [_count(out, f"vision_model.layer{s}.{{}}.conv1.weight")
                 for s in range(1, 5)]
        hidden = out["window_attn.final_layer_norm.weight"].shape[0]
        seg = (out["fusion_head.head.dense0.weight"].shape[1] // hidden - 1
               if head_type == "mlp" else 16)
        build = lambda: TwoStreamWindow(  # noqa: E731
            BertModel(bert_cfg), ResNet(50, n_segment=seg, stage_sizes=sizes),
            window_size=window_size, segment_size=seg, hidden_size=hidden,
            head_type=head_type)
    with torch.device("meta"):
        model = build()
    model.load_state_dict(out, strict=True, assign=True)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
    p = argparse.ArgumentParser(description="torch checkpoints -> the "
                                "port's state dicts")
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--window_size", type=int, default=1)
    p.add_argument("--head_type", default="mlp")
    args = p.parse_args(argv)

    sd = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    # strip DDP 'module.' prefixes
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    out = convert(args.kind, sd, args.window_size, args.head_type)
    torch.save(out, args.out)
    n = sum(v.numel() for v in out.values() if v.is_floating_point())
    print(f"wrote {n:,} parameters to {args.out}")
    return out


if __name__ == "__main__":
    main()
