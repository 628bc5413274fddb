"""Importing the PyTorch port never loads jax or flax (checked in a fresh
interpreter, since this test process has imported both)."""

import subprocess
import sys
import textwrap
from pathlib import Path

MODULES = [
    "video_chapter_generation_tpu_torch",
    "video_chapter_generation_tpu_torch.device",
    "video_chapter_generation_tpu_torch.ops._build",
    "video_chapter_generation_tpu_torch.ops.preprocess",
    "video_chapter_generation_tpu_torch.ops.temporal_shift",
    "video_chapter_generation_tpu_torch.ops.stem",
    "video_chapter_generation_tpu_torch.ops.tsm_block",
    "video_chapter_generation_tpu_torch.models.resnet",
    "video_chapter_generation_tpu_torch.models.bert",
    "video_chapter_generation_tpu_torch.models.fusion",
    "video_chapter_generation_tpu_torch.models.seq2seq",
    "video_chapter_generation_tpu_torch.models.convert",
    "video_chapter_generation_tpu_torch.pipeline",
    "video_chapter_generation_tpu_torch.pipeline.boundary",
    "video_chapter_generation_tpu_torch.pipeline.whole_video",
]


def test_port_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax"))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
