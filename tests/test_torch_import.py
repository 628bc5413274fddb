"""Importing the PyTorch port never loads jax, flax or the JAX package
(checked in a fresh interpreter, since this test process has imported
them): every module of the port is imported, and chip_smoke.py is loaded
as a module without running its main."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = "video_chapter_generation_tpu_torch"


def _port_modules():
    """Every module of the port, found from its files."""
    pkg = ROOT / PORT
    out = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


MODULES = _port_modules()


def test_port_module_list_is_complete():
    for name in ("ops.tsm_block_train", "ops.stem_train",
                 "ops.tsm_trunk_train", "train.loop", "cli.train_segment",
                 "core.checkpoint", "data.datasets", "evalkit.boundary",
                 "ops.sparse_attention", "models.sparse_attention",
                 "ops.tsm_conv", "ops.temporal_shift", "ops.preprocess",
                 "evalkit.metrics", "models.fusion", "pipeline.boundary",
                 "pipeline.vision_emb", "cli.extract_vision_emb",
                 "cli.infer_video", "cli.train_title", "data.native_loader",
                 "train.objectives", "models.seq2seq", "models.bert",
                 "cli.eval_segment", "cli.eval_title", "cli.pretrain_lang",
                 "evalkit.rouge", "evalkit.segment_eval",
                 "evalkit.title_eval", "datasetkit.flatten", "train.optim",
                 "train.tasks", "parallel", "parallel.dist", "parallel.mesh",
                 "pipeline.sharded", "models.gpt", "cli.sample_lang",
                 "datasetkit.glove", "ops._calls", "parallel.loader",
                 "models.contrastive", "models.fusion_variants",
                 "models.convert_reference", "cli.pretrain_contrastive",
                 "cli.train_listwise", "cli.convert_weights",
                 "cli.export_tokenizer", "visualization.interpret",
                 "visualization.frames", "utils.memory", "utils.profiling",
                 "utils.flops", "datasetkit.parsing", "datasetkit.acquire",
                 "datasetkit.filtering", "datasetkit.merge",
                 "datasetkit.sampler", "datasetkit.split", "datasetkit.stats",
                 "datasetkit.topics", "models.convert_hf"):
        assert f"{PORT}.{name}" in MODULES, name


def test_port_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, sys
        for name in {MODULES!r}:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax")
                     or m == "video_chapter_generation_tpu"
                     or m.startswith("video_chapter_generation_tpu."))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
