#!/usr/bin/env python3
"""Drive the PyTorch port's chaptering serving path once on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of a checkout; needs CUDA,
                                  nvcc and PIL; no network)

1. Prints the card's name and power limit (nvidia-smi), then builds the
   port's CUDA kernels from csrc/ (one nvcc per source, in parallel).
2. Builds the full-width serving models with seeded random weights drawn
   in the JAX package's parameter layout and carried over by
   models/convert.py: TwoStream = BERT-base + ResNet50-TSM (T = 16, uint8
   s2d stem, bf16) + the mlp ChapterHead, and Pegasus-large titles (bf16).
3. Holds every kernel against its plain PyTorch version at every shape of
   one vision call (16 clips x 16 frames = 256 frames at 224 px, real
   frames and weights, each block fed the kernel output of the last),
   and times both with CUDA events; then holds the whole trunk (kernels,
   bf16, on the card) against the plain float32 trunk on the CPU for one
   clip.
4. Runs ChapterPipeline.run(pipelined=True) with frame_pack=True over
   synthetic 300-s videos, with the head bias shifted so clip scores
   straddle 0.5 (as bench_pipeline.py does), and checks the launch
   counts (per vision call: stem 1, stride-1 bottleneck 13, stride-2
   bottleneck 3), finite scores, and at least one cut point and one
   title per video.
5. Training. Holds every training kernel entry (the K11 stem and the K12
   bottleneck of each kind, forward and backward, and the K13 trunk's
   recomputation of p) against its plain PyTorch version at every shape
   of one full-width step (8 clips x 16 frames = 128 frames at 224 px,
   bf16), with the forward output, the batch statistics and every
   gradient compared and both timed; holds the trunk Function bit for bit
   to the chain of per-block Functions and checks that it keeps no p;
   then trains the port's cli/train_segment on a synthetic corpus
   for a few AdamW steps (BERT-base, ResNet50-TSM s2d, mlp head,
   data.batch_size=8) and checks finite losses, moved parameters and BN
   running statistics, exact kernel launch counts per step, and a
   checkpoint that restores.
6. Prints one JSON line of the kernels and, last, the device line.

Any failed phase raises, and the script exits non-zero without printing
the final line; it also fails where CUDA is absent or the package is
not beside it.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

CLIP_FRAMES, TEXT_LEN, SCORE_BATCH = 16, 100, 16
TITLE_IN, TITLE_OUT, TITLE_BUCKET = 512, 30, 8
VIDEO_SEC, N_VIDEOS, SEED = 300, 3, 0
# bf16 bands, kernel vs plain version on the same inputs: the kernel sums
# each conv in float32 and rounds once, the plain version rounds every
# conv output to bf16 first, so the two differ by bf16 rounding only
KERNEL_MIN_COS, KERNEL_MAX_MEAN_REL = 0.999, 1e-2
# whole trunk, 53 bf16 convolutions on the card vs float32 on the CPU
TRUNK_MIN_COS = 0.99
TIMED_RUNS, WARMUP_RUNS = 15, 3
# training kernels vs their plain versions in bf16: outputs and batch
# statistics as above; gradients pass through a chain of bf16 GEMMs and
# BN backward reductions that the two versions round at different places
# and sum in different orders: at the 17 shapes of a 128-frame step the
# worst reading was cosine 0.999956 and mean relative error 8.6e-3, and
# the bands leave about twice that room (a dropped term of a BN backward
# moves a gradient by far more)
GRAD_MIN_COS, GRAD_MAX_MEAN_REL = 0.999, 2e-2
TRAIN_CLIPS, TRAIN_STEPS = 8, 4
# H100 SXM published peaks (dense bf16, HBM3), for the bounds
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def compare(got, ref):
    """(max abs error, mean relative error, cosine) in float32."""
    import torch

    g, r = got.float().flatten(), ref.float().flatten()
    d = (g - r).abs()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item()
    return d.max().item(), (d.mean() / r.abs().mean()).item(), cos


def cuda_ms(fn) -> float:
    """Median device time of fn in ms over TIMED_RUNS, after warm-up."""
    import torch

    for _ in range(WARMUP_RUNS):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound(flops: float, nbytes: float):
    """(least ms on the card for this work, what bounds it)."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def block_work(nt, h, w, c, f, co, stride, proj):
    """(forward flops, activation bytes in, weight count) of one
    bottleneck; the backward does twice the flops."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    m_in, m_out = nt * h * w, nt * ho * wo
    flops = 2 * (m_in * c * f + m_out * 9 * f * f + m_out * f * co
                 + (m_out * c * co if proj else 0))
    weights = c * f + 9 * f * f + f * co + (c * co if proj else 0)
    return flops, m_in, m_out, weights


def training_phases(dev, smi, frames, vision):
    """Every training kernel against its plain version at the shapes of
    one full-width step, then the port's train_segment for a few steps.
    Returns the kernels' JSON entries."""
    import torch

    from video_chapter_generation_tpu_torch.cli import train_segment
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        _StemTrain,
        _stem_weight,
        stem_train_bwd,
        stem_train_fwd,
        stem_train_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        BlockTrainState,
        _block,
        block_train_bwd,
        block_train_fwd,
        conv_nhwc,
        tsm_block_train_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_trunk_train import (
        STRIDES,
        recompute_p,
        trunk_train_bwd,
        trunk_train_fwd,
        tsm_trunk_train,
        unpack,
    )
    from video_chapter_generation_tpu_torch.train.tasks import SegmentTask

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x0 = frames[:TRAIN_CLIPS * CLIP_FRAMES].contiguous()  # [128, 56, 56, 48]
    entries = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "flops": 0.0,
                   "bytes": 0.0, "max_abs": 0.0}
               for k in ("stem_s2d_train_fwd", "stem_s2d_train_bwd",
                         "tsm_block_train_fwd", "tsm_block_train_bwd",
                         "tsm_trunk_train_recompute_p")}

    def held(name, label, pairs, grads=False):
        """Compare (kernel, plain) tensor pairs against the output bands or,
        for gradients, the gradient bands."""
        min_cos, max_rel = ((GRAD_MIN_COS, GRAD_MAX_MEAN_REL) if grads else
                            (KERNEL_MIN_COS, KERNEL_MAX_MEAN_REL))
        worst = (0.0, 0.0, 1.0)
        for got, ref in pairs:
            max_abs, mean_rel, cos = compare(got, ref)
            entries[name]["max_abs"] = max(entries[name]["max_abs"], max_abs)
            if not (cos >= min_cos and mean_rel <= max_rel):
                fail(f"{name} {label} disagrees with its plain version: "
                     f"max_abs {max_abs:.4g} mean_rel {mean_rel:.3g} "
                     f"cos {cos:.6f}")
            worst = (max(worst[0], max_abs), max(worst[1], mean_rel),
                     min(worst[2], cos))
        return worst

    def account(name, k_ms, p_ms, flops, nbytes):
        e = entries[name]
        e["ms"] += k_ms
        e["plain_ms"] += p_ms
        e["flops"] += flops
        e["bytes"] += nbytes

    def leaves(params):
        return [None if p is None else p.detach().clone().requires_grad_()
                for p in params]

    def grad_of(y, wrt, dy):
        return torch.autograd.grad(y, [t for t in wrt if t is not None], dy,
                                   retain_graph=True)

    # --- K11: the training stem ---
    stem_w = [vision.conv1.weight.permute(2, 3, 1, 0), vision.bn1.weight,
              vision.bn1.bias]
    pk = leaves(stem_w)
    y, mu, var = _StemTrain.apply(x0, *pk, 1e-5)
    dy = torch.randn(y.shape, generator=gen, device=dev).to(bf)
    gk = grad_of(y, pk, dy)
    frames_n = normalize_frames(depth_to_space4(x0), bf)
    pp = leaves(stem_w)
    yr, (mur, varr) = stem_train_reference(frames_n, *pp)
    gr = grad_of(yr, pp, dy)
    torch.cuda.synchronize()
    w_out = held("stem_s2d_train_fwd", "stem", [(y, yr), (mu, mur),
                                               (var, varr)])
    w_grad = held("stem_s2d_train_bwd", "stem", list(zip(gk, gr)), True)
    gb = torch.cat([vision.bn1.weight, vision.bn1.bias]).float().detach()
    wk = _stem_weight(pk[0].detach())
    kf = cuda_ms(lambda: stem_train_fwd(x0, wk, gb, 1e-5))
    pf = cuda_ms(lambda: stem_train_reference(frames_n, *pp))
    out, yc, st_, vec = stem_train_fwd(x0, wk, gb, 1e-5)
    kb = cuda_ms(lambda: stem_train_bwd(dy, out, yc, x0, gb, st_, vec, 1e-5))
    pb = cuda_ms(lambda: grad_of(yr, pp, dy))
    n, hs = x0.shape[0], x0.shape[1]
    m_conv = n * 4 * hs * hs
    flops = 2 * m_conv * 147 * 64
    account("stem_s2d_train_fwd", kf, pf, flops,
            x0.numel() + 147 * 64 * 4 + out.numel() * 2 + yc.numel() * 2)
    account("stem_s2d_train_bwd", kb, pb, flops,
            dy.numel() * 2 + out.numel() * 2 + yc.numel() * 2 + x0.numel()
            + 147 * 64 * 4 + 128 * 4)
    print(f"# {'stem_s2d_train':18s} {str(tuple(x0.shape)) + ' u8':44s} "
          f"out/stats cos {w_out[2]:.6f} mean_rel {w_out[1]:.3g} | grads "
          f"cos {w_grad[2]:.6f} mean_rel {w_grad[1]:.3g} | fwd kernel "
          f"{kf:.3f} ms plain {pf:.3f} | bwd kernel {kb:.3f} ms plain "
          f"{pb:.3f}", flush=True)
    x = y.detach()

    # --- K12: every bottleneck of the trunk, each fed the kernel output ---
    blocks = vision.blocks()
    t = CLIP_FRAMES
    trunk_in = x
    for i, blk in enumerate(blocks):
        kind = blk.kind()
        stride = 2 if kind == "s2" else 1
        params = unpack(blk.train_params(), kind)
        pk = leaves(params)
        xk = x.detach().clone().requires_grad_()
        st = BlockTrainState(x, pk, stride, t, 8, 1e-5)
        dy = torch.randn(st.y.shape, generator=gen, device=dev).to(bf)
        dxk, gk = st.backward(dy)
        pp = leaves(params)
        w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = pp
        yr, str_ = tsm_block_train_reference(
            xk, w1, w2, w3, g1, be1, g2, be2, g3, be3, t, 8, 1e-5, wp, gp,
            bep, stride)
        gr = grad_of(yr, [xk] + pp, dy)
        torch.cuda.synchronize()
        label = (f"block {i:2d} {tuple(x.shape)} F={params[0].shape[1]} "
                 f"{kind}")
        w_out = held("tsm_block_train_fwd", label,
                     [(st.y, yr)] + list(zip(st.stats_tuple(), str_)))
        gk = [dxk] + [g for g in gk if g is not None]
        w_grad = held("tsm_block_train_bwd", label, list(zip(gk, gr)), True)
        kf = cuda_ms(lambda: block_train_fwd(x, st.wf, st.gb, stride, t, 8,
                                             1e-5))
        pf = cuda_ms(lambda: tsm_block_train_reference(
            xk, w1, w2, w3, g1, be1, g2, be2, g3, be3, t, 8, 1e-5, wp, gp,
            bep, stride))
        kb = cuda_ms(lambda: block_train_bwd(
            dy, x, st.saved, st.y, st.wb, st.gb, st.stats, st.vec, stride,
            t, 8, 1e-5))
        pb = cuda_ms(lambda: grad_of(yr, [xk] + pp, dy))
        nt, h, w, c = x.shape
        f, co = st.f, st.co
        flops, m_in, m_out, nw = block_work(nt, h, w, c, f, co, stride,
                                            st.proj)
        act_out = 2 * (m_in * f + m_out * f + m_out * co * (3 if st.proj
                                                            else 2))
        account("tsm_block_train_fwd", kf, pf, flops,
                x.numel() * 2 + nw * 4 + act_out)
        account("tsm_block_train_bwd", kb, pb, 2 * flops,
                dy.numel() * 2 + x.numel() * 2 + act_out + nw * 8
                + x.numel() * 2)
        print(f"# {'tsm_block_train':18s} {label:44s} out/stats cos "
              f"{w_out[2]:.6f} mean_rel {w_out[1]:.3g} | grads cos "
              f"{w_grad[2]:.6f} mean_rel {w_grad[1]:.3g} | fwd kernel "
              f"{kf:.3f} ms plain {pf:.3f} | bwd kernel {kb:.3f} ms plain "
              f"{pb:.3f}", flush=True)

        # K13's own launch: the block's p made again from its saved z, bit
        # for bit the forward's p, and held to its plain version
        z, vec = st.saved[1], st.vec

        def plain_p():
            a = torch.relu(z.float() * vec[2 * f:3 * f] + vec[3 * f:4 * f])
            return conv_nhwc(a.to(bf), st.wf[2])

        p_k, p_r = recompute_p(st), plain_p()
        torch.cuda.synchronize()
        if not torch.equal(p_k, st.saved[2]):
            fail(f"recompute_p {label}: not the forward's p bit for bit")
        w_p = held("tsm_trunk_train_recompute_p", label, [(p_k, p_r)])
        kr, pr_ms = cuda_ms(lambda: recompute_p(st)), cuda_ms(plain_p)
        account("tsm_trunk_train_recompute_p", kr, pr_ms, 2 * m_out * f * co,
                2 * (m_out * f + f * co + m_out * co) + 16 * f)
        print(f"# {'recompute_p':18s} {label:44s} p cos {w_p[2]:.6f} mean_rel "
              f"{w_p[1]:.3g} bitwise True | kernel {kr:.3f} ms plain "
              f"{pr_ms:.3f}", flush=True)
        x = st.y.detach()
        del st, yr, gr, p_k, p_r

    # --- K13: the trunk Function against the chain of per-block
    # Functions on the same kernels. They must agree bit for bit (the
    # recomputed p is the forward's, and no kernel reduces with atomics),
    # and the trunk must keep less on the card after its forward: no p.
    tparams = [blk.train_params() for blk in blocks]
    kinds = [blk.kind() for blk in blocks]
    dy = torch.randn(x.shape, generator=gen, device=dev).to(bf)

    def run(fn, params):
        x_in = trunk_in.detach().clone().requires_grad_()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        y, stats = fn(x_in, params)
        kept = torch.cuda.memory_allocated(dev) - base
        wrt = [x_in] + [q for p in params for q in p if q is not None]
        grads = torch.autograd.grad(y, wrt, dy)
        return kept, [y] + [s for st in stats for s in st] + list(grads)

    def chain(x_in, params):
        stats = []
        for p12, kind in zip(params, kinds):
            x_in, st = _block(x_in, p12, STRIDES[kind], t, 8, 1e-5)
            stats.append(st)
        return x_in, stats

    kept_t, out_t = run(lambda x_in, ps: tsm_trunk_train(x_in, ps, kinds, t),
                        [leaves(p) for p in tparams])
    kept_c, out_c = run(chain, [leaves(unpack(p, k))
                                for p, k in zip(tparams, kinds)])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out_t, out_c)):
        fail("tsm_trunk_train and the chain of per-block Functions differ")
    del out_t, out_c
    dparams = [[q.detach() for q in p] for p in tparams]
    _, states = trunk_train_fwd(trunk_in, dparams, kinds, t, 8, 1e-5)
    p_bytes = sum(st.y.numel() * 2 for st in states)  # p is y's shape
    # the caching allocator may hand a tensor a cached block up to 1 MiB
    # larger than it asked for
    if kept_c - kept_t < p_bytes - len(states) * 2 ** 20:
        fail(f"the trunk keeps {kept_t} bytes after its forward, the chain "
             f"{kept_c}: fewer than the {p_bytes} bytes of p saved")
    kf = cuda_ms(lambda: trunk_train_fwd(trunk_in, dparams, kinds, t, 8,
                                         1e-5))
    kb = cuda_ms(lambda: trunk_train_bwd(dy, list(states)))
    del states
    torch.cuda.empty_cache()
    print(f"# {'tsm_trunk_train':18s} {str(tuple(trunk_in.shape)):44s} "
          f"vs block chain: bitwise True; kept after the forward {kept_t} "
          f"bytes vs {kept_c} ({kept_c - kept_t} less, p is {p_bytes}) | "
          f"fwd {kf:.3f} ms bwd {kb:.3f} ms (blocks' sum "
          f"{entries['tsm_block_train_fwd']['ms']:.3f} / "
          f"{entries['tsm_block_train_bwd']['ms']:.3f}) on {smi}", flush=True)

    # --- the main path: the port's train_segment, a few full-width steps ---
    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    n_train = TRAIN_CLIPS * TRAIN_STEPS
    paths = make_synth_corpus_on_disk(
        str(build / "synth_train_corpus"), n_videos=n_train + 2,
        video_sec=60, seed=SEED + 3, splits={"train": n_train, "val": 2})
    argv = [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            f"data.val_vid_file={paths['val_vid_file']}",
            "model.kind=two_stream", "model.stem_input=s2d",
            f"data.batch_size={TRAIN_CLIPS}", "train.max_epochs=1",
            f"train.ckpt_dir={build / 'train_ckpt'}",
            f"train.log_dir={build / 'train_logs'}",
            "train.keep_checkpoints=1", "train.resume=false"]
    counted = {"stem_s2d_train_fwd": stem_train_fwd,
               "stem_s2d_train_bwd": stem_train_bwd,
               "tsm_block_train_fwd": block_train_fwd,
               "tsm_block_train_bwd": block_train_bwd,
               "tsm_trunk_train_recompute_p": recompute_p}
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.time()
    trainer = train_segment.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {name: fn.launches for name, fn in counted.items()}
    steps = trainer.step
    per_step = {"stem_s2d_train_fwd": 1, "stem_s2d_train_bwd": 1,
                "tsm_block_train_fwd": len(blocks),
                "tsm_block_train_bwd": len(blocks),
                "tsm_trunk_train_recompute_p": len(blocks)}
    want = {k: v * steps for k, v in per_step.items()}
    print(f"# train_segment: {steps} steps of {TRAIN_CLIPS} clips in "
          f"{wall:.1f} s (build, data and checkpoint included), peak device "
          f"memory {peak} bytes, launches {launches}", flush=True)
    if not 3 <= steps <= 6:
        fail(f"train_segment ran {steps} steps, not 3-6")
    if launches != want:
        fail(f"training launch counts {launches} != {want}")
    losses = [json.loads(line) for line in
              open(build / "train_logs" / "scalars.jsonl")]
    loss = [r["value"] for r in losses if r["tag"] == "train/loss"][-1]
    if not math.isfinite(loss):
        fail(f"training loss {loss} is not finite")
    model = trainer.model
    init = SegmentTask(trainer.cfg).init_state()
    trained = model.state_dict()
    moved = [k for k in init if not k.endswith("num_batches_tracked")
             and not torch.equal(init[k], trained[k].cpu())]
    params = {k for k, _ in model.named_parameters()}
    stats_moved = [k for k in moved if k not in params]
    print(f"# {len(set(moved) & params)} of {len(params)} parameter tensors "
          f"and {len(stats_moved)} BN running statistics moved; mean loss "
          f"{loss:.4f}", flush=True)
    if not set(moved) & params or not stats_moved:
        fail("training moved no parameters or no BN running statistics")
    ckpt = CheckpointManager(str(build / "train_ckpt"))
    epoch, state = ckpt.restore_latest()
    bad = [k for k, v in state["model"].items()
           if not torch.equal(v, trained[k].cpu())]
    if bad or state["step"] != steps:
        fail(f"checkpoint of epoch {epoch} does not restore: {bad[:3]}")
    rate = steps / trainer.timer.summary()["train_step"]["seconds"]
    print(f"# train steps/s {rate:.3f} (mean over {steps} steps, "
          f"host data and first-step build included) on {smi}; "
          f"information only", flush=True)
    del trainer, model
    torch.cuda.empty_cache()

    sources = {"stem": ("csrc/stem_train.cu",
                        "video_chapter_generation_tpu/ops/"
                        "stem_train_pallas.py:329"),
               "block": ("csrc/conv_train.cu",
                         "video_chapter_generation_tpu/ops/"
                         "tsm_block_train_pallas.py:1483"),
               "trunk": ("csrc/conv_train.cu",
                         "video_chapter_generation_tpu/ops/"
                         "tsm_trunk_train_pallas.py:118")}
    out = []
    for name, e in entries.items():
        src, replaces = sources[name.split("_")[0] if name.startswith("stem")
                                else name.split("_")[1]]
        b_ms, b_by = bound(e["flops"], e["bytes"])
        out.append({"name": name, "route": "cuda",
                    "source": f"video_chapter_generation_tpu_torch/{src}",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": e["max_abs"], "ms": e["ms"],
                    "plain_ms": e["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from video_chapter_generation_tpu_torch.core.metrics import StepTimer
    from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.data.tokenization import (
        UnigramTokenizer,
        WordPieceTokenizer,
    )
    from video_chapter_generation_tpu_torch.models import convert
    from video_chapter_generation_tpu_torch.models.bert import (
        BertConfig,
        BertModel,
    )
    from video_chapter_generation_tpu_torch.models.fusion import TwoStream
    from video_chapter_generation_tpu_torch.models.resnet import (
        STAGE_SIZES,
        ResNet,
    )
    from video_chapter_generation_tpu_torch.models.seq2seq import (
        Seq2Seq,
        Seq2SeqConfig,
        generate,
    )
    from video_chapter_generation_tpu_torch.ops import _build
    from video_chapter_generation_tpu_torch.ops.stem import (
        stem_s2d,
        stem_s2d_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_reference,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.pipeline import (
        ChapterPipeline,
        bucket_title_fn,
        make_packed_two_stream_score_fn,
        pack_to_device,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    bf = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    libs = _build.build_all()
    print(f"# built {sorted(libs)} in {time.time() - t0:.2f} s", flush=True)

    # --- models: seeded random weights in the JAX layout, carried over ---
    t0 = time.time()
    sizes = STAGE_SIZES[50]
    with torch.device("meta"):
        model = TwoStream(
            BertModel(BertConfig()),
            ResNet(50, n_segment=CLIP_FRAMES, stem_input="s2d", dtype=bf),
            segment_size=CLIP_FRAMES, hidden_size=128, dtype=bf)
        s2s = Seq2Seq(Seq2SeqConfig.pegasus_large())
    ts_entries = convert.two_stream_entries(12, sizes)
    ts_tree = convert.random_jax_tree(model, ts_entries, seed=SEED)
    model.load_state_dict(convert.from_jax_two_stream(ts_tree, 12, sizes),
                          assign=True)
    model.to_serving(dev)
    s2s_tree = convert.random_jax_tree(s2s, convert.seq2seq_entries(s2s.cfg),
                                       seed=SEED + 1)
    s2s.load_state_dict(convert.from_jax_seq2seq(s2s_tree, s2s.cfg),
                        assign=True)
    s2s.to(dev, bf).eval()
    del ts_tree, s2s_tree
    print(f"# models ready in {time.time() - t0:.1f} s", flush=True)

    # --- corpus and tokenizers ---
    t0 = time.time()
    paths = make_synth_corpus_on_disk(
        str(ROOT / "video_chapter_generation_tpu_torch" / "_build"
            / "synth_corpus"), n_videos=N_VIDEOS, video_sec=VIDEO_SEC)
    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["vid_file"], paths["subtitle_dir"])
    texts = [s["text"] for vid in corpus.vids
             for s in corpus.subtitles(vid)][:2000]
    tokenizer = WordPieceTokenizer.build_from_corpus(texts, vocab_size=4000)
    title_tok = UnigramTokenizer.build_from_corpus(texts, vocab_size=4000)
    print(f"# frame source: synthetic JPEG corpus (data/synth.py), decoded "
          f"by PIL; {N_VIDEOS} videos x {VIDEO_SEC} s, ready in "
          f"{time.time() - t0:.1f} s", flush=True)

    title_rows = []

    def raw_title_fn(enc_ids, enc_mask):
        ids = generate(s2s, torch.from_numpy(enc_ids).to(dev).long(),
                       torch.from_numpy(enc_mask).to(dev), max_len=TITLE_OUT)
        out = ids.cpu().numpy()
        title_rows.extend(out)
        return out

    def decode_fn(row):  # random weights emit arbitrary ids; decode safely
        return title_tok.decode([int(i) for i in row
                                 if 0 <= int(i) < title_tok.vocab_size])

    pipe = ChapterPipeline(
        corpus, tokenizer, make_packed_two_stream_score_fn(model, dev),
        bucket_title_fn(raw_title_fn, TITLE_BUCKET), decode_fn,
        clip_frame_num=CLIP_FRAMES, max_text_len=TEXT_LEN,
        title_input_len=TITLE_IN, batch_size=SCORE_BATCH, score_mode="all",
        title_tokenizer=title_tok, frame_pack=True, device=dev)

    # --- every kernel against its plain version at the main-path shapes ---
    vision = model.vision_model
    stem_p, block_ps = vision.folded_params()
    _, _, batches, pack = pipe._prepare(corpus.vids[0])
    idx = torch.from_numpy(batches[0][1]["frame_idx"]).to(dev).long()
    frames = pack_to_device(pack, dev)[idx.reshape(-1)]  # [256, 56, 56, 48]
    stats = {name: {"ms": [], "plain_ms": [], "max_abs": 0.0, "flops": 0,
                    "bytes": 0}
             for name in ("stem_s2d", "tsm_bottleneck", "tsm_bottleneck_s2")}

    def check(name, label, kernel, plain, flops, nbytes):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        max_abs, mean_rel, cos = compare(got, ref)
        k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
        st = stats[name]
        st["ms"].append(k_ms)
        st["plain_ms"].append(p_ms)
        st["max_abs"] = max(st["max_abs"], max_abs)
        st["flops"] += flops
        st["bytes"] += nbytes
        print(f"# {name:18s} {label:44s} max_abs {max_abs:.4g} mean_rel "
              f"{mean_rel:.3g} cos {cos:.6f} | kernel {k_ms:.3f} ms plain "
              f"{p_ms:.3f} ms", flush=True)
        if not (cos >= KERNEL_MIN_COS and mean_rel <= KERNEL_MAX_MEAN_REL):
            fail(f"{name} {label} disagrees with its plain version")
        return got

    n_fr, hs = frames.shape[0], frames.shape[1]
    y = check("stem_s2d", f"{tuple(frames.shape)} u8",
              lambda: stem_s2d(frames, stem_p["w7"], stem_p["s"],
                               stem_p["b"]),
              lambda: stem_s2d_reference(frames, stem_p["w7"], stem_p["s"],
                                         stem_p["b"]),
              2 * n_fr * 4 * hs * hs * 147 * 64,
              frames.numel() + 147 * 64 * 2 + n_fr * hs * hs * 64 * 2)
    for i, (blk, p) in enumerate(zip(vision.blocks(), block_ps)):
        args = (p["w1"], p["w2"], p["w3"], p["s1"], p["b1"], p["s2"],
                p["b2"], p["s3"], p["b3"])
        x = y
        label = (f"block {i:2d} {tuple(x.shape)} F={p['w1'].shape[1]}"
                 + (" proj" if p["wp"] is not None else ""))
        plain = (lambda x=x, args=args, p=p, s=blk.stride:
                 tsm_bottleneck_reference(x, *args, CLIP_FRAMES, 8, p["wp"],
                                          p["sp"], p["bp"], stride=s))
        nt, h, w, c = x.shape
        f, co = p["w1"].shape[1], p["w3"].shape[1]
        flops, _, m_out, nw = block_work(nt, h, w, c, f, co, blk.stride,
                                         p["wp"] is not None)
        work = (flops, x.numel() * 2 + nw * 2 + m_out * co * 2)
        if blk.stride == 2:
            y = check("tsm_bottleneck_s2", label,
                      lambda x=x, args=args, p=p: tsm_bottleneck_s2(
                          x, *args, p["wp"], p["sp"], p["bp"], CLIP_FRAMES),
                      plain, *work)
        else:
            y = check("tsm_bottleneck", label,
                      lambda x=x, args=args, p=p: tsm_bottleneck(
                          x, *args, CLIP_FRAMES, 8, p["wp"], p["sp"],
                          p["bp"]),
                      plain, *work)

    # --- the whole trunk on one clip vs the float32 plain trunk on CPU ---
    cpu_trunk = ResNet(50, n_segment=CLIP_FRAMES, stem_input="s2d").eval()
    cpu_trunk.load_state_dict(vision.state_dict())
    clip = frames[:CLIP_FRAMES]
    max_abs, mean_rel, cos = compare(vision(clip).cpu(),
                                     cpu_trunk(clip.cpu()))
    print(f"# trunk, one clip, kernels bf16 vs plain f32 on CPU: max_abs "
          f"{max_abs:.4g} mean_rel {mean_rel:.3g} cos {cos:.6f}", flush=True)
    if not cos >= TRUNK_MIN_COS:
        fail("the vision trunk disagrees with its float32 plain version")

    # --- warm-up video, head-bias calibration (bench_pipeline.py:226-239) ---
    t0 = time.time()
    warm = pipe.run([corpus.vids[0]])[corpus.vids[0]]
    med = float(np.clip(np.median(warm.clip_scores), 1e-6, 1 - 1e-6))
    delta = -math.log(med / (1.0 - med))
    with torch.no_grad():
        model.fusion_head.head.bias[1] += delta
    print(f"# warm-up video {time.time() - t0:.1f} s, head bias shifted by "
          f"{delta:+.3f}", flush=True)

    # --- the main path, counted ---
    counted = (stem_s2d, tsm_bottleneck, tsm_bottleneck_s2)
    for fn in counted:
        fn.launches = 0
    title_rows.clear()
    pipe.timer = StepTimer()
    t0 = time.time()
    results = pipe.run(list(corpus.vids), pipelined=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in counted}

    calls = sum(math.ceil(len(r.clip_scores) / SCORE_BATCH)
                for r in results.values())
    want = {"stem_s2d": calls, "tsm_bottleneck": 13 * calls,
            "tsm_bottleneck_s2": 3 * calls}
    print(f"# main path: {len(results)} videos, {calls} vision calls, "
          f"launches {launches}", flush=True)
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    for vid, r in results.items():
        scores = np.asarray(r.clip_scores, np.float64)
        print(f"# {vid}: {len(scores)} clips, {len(r.cut_points)} cut "
              f"points {r.cut_points}, {len(r.titles)} titles", flush=True)
        if not (np.isfinite(scores).all() and (scores >= 0).all()
                and (scores <= 1).all()):
            fail(f"{vid}: clip scores outside [0, 1]")
        if not r.cut_points or len(r.titles) != len(r.cut_points):
            fail(f"{vid}: {len(r.cut_points)} cut points, "
                 f"{len(r.titles)} titles")
    rows = np.asarray(title_rows)
    if rows.shape[1:] != (TITLE_OUT,) or rows.min() < 0 or \
            rows.max() >= s2s.cfg.vocab_size:
        fail(f"title id rows malformed: {rows.shape}")
    first = next(iter(results.values()))
    print(f"# first title ids {rows[0][:10].tolist()}; decoded (ids inside "
          f"the tokenizer's vocabulary only) {first.titles[0]!r}")
    print(f"# stage seconds {json.dumps(pipe.timer.summary())}", flush=True)
    print(f"# {60.0 * len(results) / wall:.2f} videos/min end to end "
          f"({wall:.1f} s for {len(results)} videos, pipelined) on {smi}; "
          f"information only, not a benchmark", flush=True)

    train_kernels = training_phases(dev, smi, frames, vision)

    sources = {"stem_s2d": ("csrc/stem_s2d.cu",
                            "video_chapter_generation_tpu/ops/stem_pallas.py:275"),
               "tsm_bottleneck": ("csrc/tsm_bottleneck.cu",
                                  "video_chapter_generation_tpu/ops/"
                                  "tsm_block_pallas.py:1094"),
               "tsm_bottleneck_s2": ("csrc/tsm_bottleneck.cu",
                                     "video_chapter_generation_tpu/ops/"
                                     "tsm_block_pallas.py:654")}
    kernels = []
    for name, st in stats.items():
        src, replaces = sources[name]
        b_ms, b_by = bound(st["flops"], st["bytes"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"video_chapter_generation_tpu_torch/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": st["max_abs"],
            # per vision call: the sum over the shapes one call runs
            "ms": sum(st["ms"]), "plain_ms": sum(st["plain_ms"]),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    # training entries: per step, the sum over the shapes one step runs
    print(json.dumps({"kernels": kernels + train_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
