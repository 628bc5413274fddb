"""Sharded serving over the devices of one process, and video-level
fan-out over processes (counterpart of the JAX package's
pipeline/sharded.py:1-170).

The JAX package runs each scorer as one jitted call whose batch dim XLA
splits over the mesh's data axis. Here each data shard's rows run on its
own device, through the unsharded scorer (pipeline/boundary.py) bound to
a replica of the model there: one replica per distinct device, copied
once when the scorer is built, shared by the shards on that device.
Shards on one device run one after the other; over several cards each
card's shards run from a host thread of their own, with that card
current, so one card's host dispatch does not hold back the others. The
scores come back to the host in row order.

Batch-size contract (as the JAX package's): score_clips pads the last
batch to batch_size, so sharded scoring needs batch_size divisible by
the data axis (else ValueError "not divisible"); the title wrapper pads
the chapter rows itself.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import dist
from ..parallel.mesh import DATA_AXIS, Mesh, shard_rows
from .boundary import (
    make_text_score_fn,
    make_two_stream_score_fn,
    make_window_score_fn,
)


def replicate(module: torch.nn.Module, device: torch.device
              ) -> torch.nn.Module:
    """A copy of `module` on `device`: its parameters and buffers copied
    straight to the device (dtypes kept), the rest deep-copied."""
    memo = {}
    for p in module.parameters():
        memo[id(p)] = torch.nn.Parameter(p.detach().to(device, copy=True),
                                         requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = b.detach().to(device, copy=True)
    return copy.deepcopy(module, memo)


def _replicas(model: torch.nn.Module, mesh: Mesh
              ) -> Dict[torch.device, torch.nn.Module]:
    """One replica a distinct device of the data axis: the model itself
    where it lies already."""
    home = next(model.parameters()).device
    return {d: model if d == home else replicate(model, d)
            for d in dict.fromkeys(mesh.data_devices())}


def _on(device: torch.device):
    """The device current for a shard's work (CUDA), else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _run_shards(devices: List[torch.device], work: Callable,
                shards: List, gather: Callable[[List], List]) -> List:
    """work(device, shard) for every shard, each on its device; gather
    turns one device's outputs (its shards in order) into host values.
    Returns the host values in shard order. Several devices: a thread a
    device."""
    groups: Dict[torch.device, List[int]] = {}
    for i, d in enumerate(devices):
        groups.setdefault(d, []).append(i)

    def run(d, idx):
        with _on(d):
            return idx, gather([work(d, shards[i]) for i in idx])

    if len(groups) == 1:
        done = [run(*next(iter(groups.items())))]
    else:
        with ThreadPoolExecutor(len(groups)) as pool:
            futures = [pool.submit(run, d, idx) for d, idx in groups.items()]
            done = [f.result() for f in futures]
    out: List = [None] * len(shards)
    for idx, values in done:
        for i, v in zip(idx, values):
            out[i] = v
    return out


def _scores_to_host(outs: List[torch.Tensor]) -> List[torch.Tensor]:
    """One device's score shards -> float32 host tensors (one copy)."""
    sizes = [o.shape[0] for o in outs]
    return list(torch.cat([o.float() for o in outs]).cpu().split(sizes))


def _sharded_scorer(mesh: Mesh, fns: Dict[torch.device, Callable],
                    keys: Sequence[str]) -> Callable:
    devices = mesh.data_devices()

    def score(batch) -> torch.Tensor:
        shards = shard_rows(mesh, {k: batch[k] for k in keys})
        return torch.cat(_run_shards(devices, lambda d, s: fns[d](s),
                                     shards, _scores_to_host))

    return score


def _scales_on(quant_scales, device):
    if quant_scales is None:
        return None
    return {k: {n: torch.as_tensor(v).to(device) for n, v in part.items()}
            for k, part in quant_scales.items()}


def make_sharded_text_score_fn(model, mesh: Mesh) -> Callable:
    """Data-sharded make_text_score_fn: batch["text_ids"] and
    ["attention_mask"] -> positive-class probability [B], float32 on the
    host."""
    fns = {d: make_text_score_fn(m, d) for d, m in
           _replicas(model, mesh).items()}
    return _sharded_scorer(mesh, fns, ("text_ids", "attention_mask"))


def make_sharded_two_stream_score_fn(model, mesh: Mesh,
                                     normalize: bool = True,
                                     quant_scales=None) -> Callable:
    """Data-sharded make_two_stream_score_fn: each shard's uint8 frames
    are normalized on its device (K6); quant_scales (calibrated once,
    ops/quantize.py:calibrate_two_stream_quant) serve every replica's
    trunk in W8A8."""
    fns = {d: make_two_stream_score_fn(m, d, normalize,
                                       _scales_on(quant_scales, d))
           for d, m in _replicas(model, mesh).items()}
    return _sharded_scorer(mesh, fns,
                           ("img_clip", "text_ids", "attention_mask"))


def make_sharded_window_score_fn(model, mesh: Mesh,
                                 quant_scales=None) -> Callable:
    """Data-sharded make_window_score_fn (InferWindowClipDataset batches).
    quant_scales as for the two-stream scorer; the JAX function takes
    none, so its sharded window scorer drops --int8_vision (ROADMAP
    queue 3)."""
    fns = {d: make_window_score_fn(m, d, quant_scales=_scales_on(
        quant_scales, d)) for d, m in _replicas(model, mesh).items()}
    score = _sharded_scorer(mesh, fns,
                            ("img_clips", "text_ids", "attention_mask"))
    score.model = model  # the served model, for callers that inspect it
    return score


def shard_title_fn(title_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap a ChapterPipeline title_fn so its chapter rows shard over the
    data axis: the rows are padded (repeating the last one) to a
    multiple of the data axis, each shard decodes on its device, and the
    pad rows are dropped. Both signatures: (ids, mask) and the vision
    one (ids, mask, vision_embs, vision_mask). A title_fn with a
    `replicate(device)` method (cli/eval_title.build_title_model's) gets
    a replica of its title model on each distinct device; one without
    runs every shard as it is."""
    devices = mesh.data_devices()
    n = mesh.shape[DATA_AXIS]
    rep = getattr(title_fn, "replicate", None)
    fns = {d: (rep(d) if rep is not None else title_fn)
           for d in dict.fromkeys(devices)}

    def fn(*arrays):
        arrays = [np.asarray(a) for a in arrays]
        rows = arrays[0].shape[0]
        pad = (-rows) % n
        if pad:
            arrays = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                      for a in arrays]
        per = (rows + pad) // n
        shards = [[a[i * per:(i + 1) * per] for a in arrays]
                  for i in range(n)]
        outs = _run_shards(devices, lambda d, s: list(fns[d](*s)), shards,
                           lambda values: values)
        return [row for out in outs for row in out][:rows]

    return fn


def run_videos_distributed(pipe, vids: Optional[Sequence[str]] = None,
                           pipelined: bool = True, lookahead: int = 2):
    """Video-level fan-out over processes: each process chapters
    vids[rank::world] with its own pipeline (whose scorer and title fn
    may be sharded over its cards), then every process receives the
    merged {vid: VideoChapters}, in the order of `vids`, through
    all_gather_object. A process left without videos serves none (the
    JAX function then serves the whole corpus: ChapterPipeline.run reads
    an empty list as all videos)."""
    vids = list(vids if vids is not None else pipe.corpus.vids)
    rank, world = dist.process_index(), dist.process_count()
    local = vids[rank::world]
    local_out = (pipe.run(local, pipelined=pipelined, lookahead=lookahead)
                 if local else {})
    merged: Dict = {}
    for part in dist.all_gather_object(local_out):
        merged.update(part)
    return {vid: merged[vid] for vid in vids if vid in merged}
