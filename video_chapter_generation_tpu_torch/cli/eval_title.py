"""The title model from a checkpoint (counterpart of the JAX package's
cli/eval_title.py). Of that CLI, `_restore` (:215-248) is ported, as the
serving CLI needs it; the ROUGE evaluation itself is ROADMAP queue 1
item 11.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.checkpoint import CheckpointManager
from ..core.contract import assert_contract


def _restore(cfg, task) -> Dict[str, torch.Tensor]:
    """The title model's float32 state dict, for any title family (the
    task's config says which) and for the plain (TitleGenTask, model kind
    "title") and vision-conditioned (TitleGenVisionTask, "title_vision")
    models: the best checkpoint of the task's kind in cfg.train.ckpt_dir
    (cli/train_title writes them), else the task's seeded random weights,
    with a line saying which. Checkpoints of other kinds (the boundary
    model shares the directory in cli/infer_video; a plain title model is
    no vision one) are passed over; a checkpoint without a contract counts
    as a plain title one, as the JAX package's checkpoints may lack it. A
    checkpoint of the task's kind whose contract does not match raises
    ContractMismatch: it never degrades to random weights."""
    ckpt = CheckpointManager(cfg.train.ckpt_dir)
    best = ckpt.best_step()
    if best is None:
        print(f"no checkpoint restored (none in {cfg.train.ckpt_dir}): "
              f"random title weights")
        return task.init_state()
    want = task.contract["model_kind"]
    step = ckpt.best_step(want, default_kind="title")
    if step is None:
        print(f"no checkpoint restored (epoch {best} in "
              f"{cfg.train.ckpt_dir} is a {ckpt.model_kind(best) or 'title'} "
              f"checkpoint, none is a {want} one): random title weights")
        return task.init_state()
    assert_contract(ckpt.metrics_for(step).get("contract") or {},
                    task.contract, context="checkpoint load")
    _, state = ckpt.restore_raw(step)
    print(f"restored checkpoint at epoch {step} (step {state['step']})")
    return state["model"]
