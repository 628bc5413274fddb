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
5. Prints one JSON line of the kernels and, last, the device line.

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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from video_chapter_generation_tpu.core.metrics import StepTimer
    from video_chapter_generation_tpu.data.corpus import VideoCorpus
    from video_chapter_generation_tpu.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu.data.tokenization import (
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
    stats = {name: {"ms": [], "plain_ms": [], "max_abs": 0.0}
             for name in ("stem_s2d", "tsm_bottleneck", "tsm_bottleneck_s2")}

    def check(name, label, kernel, plain):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        max_abs, mean_rel, cos = compare(got, ref)
        k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
        st = stats[name]
        st["ms"].append(k_ms)
        st["plain_ms"].append(p_ms)
        st["max_abs"] = max(st["max_abs"], max_abs)
        print(f"# {name:18s} {label:44s} max_abs {max_abs:.4g} mean_rel "
              f"{mean_rel:.3g} cos {cos:.6f} | kernel {k_ms:.3f} ms plain "
              f"{p_ms:.3f} ms", flush=True)
        if not (cos >= KERNEL_MIN_COS and mean_rel <= KERNEL_MAX_MEAN_REL):
            fail(f"{name} {label} disagrees with its plain version")
        return got

    y = check("stem_s2d", f"{tuple(frames.shape)} u8",
              lambda: stem_s2d(frames, stem_p["w7"], stem_p["s"],
                               stem_p["b"]),
              lambda: stem_s2d_reference(frames, stem_p["w7"], stem_p["s"],
                                         stem_p["b"]))
    for i, (blk, p) in enumerate(zip(vision.blocks(), block_ps)):
        args = (p["w1"], p["w2"], p["w3"], p["s1"], p["b1"], p["s2"],
                p["b2"], p["s3"], p["b3"])
        x = y
        label = (f"block {i:2d} {tuple(x.shape)} F={p['w1'].shape[1]}"
                 + (" proj" if p["wp"] is not None else ""))
        plain = (lambda x=x, args=args, p=p, s=blk.stride:
                 tsm_bottleneck_reference(x, *args, CLIP_FRAMES, 8, p["wp"],
                                          p["sp"], p["bp"], stride=s))
        if blk.stride == 2:
            y = check("tsm_bottleneck_s2", label,
                      lambda x=x, args=args, p=p: tsm_bottleneck_s2(
                          x, *args, p["wp"], p["sp"], p["bp"], CLIP_FRAMES),
                      plain)
        else:
            y = check("tsm_bottleneck", label,
                      lambda x=x, args=args, p=p: tsm_bottleneck(
                          x, *args, CLIP_FRAMES, 8, p["wp"], p["sp"],
                          p["bp"]),
                      plain)

    # --- the whole trunk on one clip vs the float32 plain trunk on CPU ---
    cpu_trunk = ResNet(50, n_segment=CLIP_FRAMES, stem_input="s2d")
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
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"video_chapter_generation_tpu_torch/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": st["max_abs"],
            # per vision call: the sum over the shapes one call runs
            "ms": sum(st["ms"]), "plain_ms": sum(st["plain_ms"])})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
