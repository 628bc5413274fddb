"""Boundary scoring with the window model, in the run's own process:
eval_segment's path over the seed's video pool: the program's
flatten_video_to_clips, an InferWindowClipDataset (each target clip with
its neighbours 16 s before and after), score_clips with the window
score function (K6, then the frames stem and the bottlenecks on 3 clips
of frames a scored clip), then cut points. No titles.

Set-up: the frame library (first run in a checkout only); the
reference's probabilities of the pool's shortest video, from which the
boundary head's positive bias is shifted so that it gets its share of
the traffic's chapters a video (weights made from the seed, the shift
applied to both sides' copies); then the program is built with those
weights and warmed on the same video, which runs every shape the
window uses.

Window: a fixed amount of work, the same on every seed: `passes` whole
passes over the pool, in the seed's order, where passes is the number
that `--seconds` holds at the traffic's `work_rate_s_per_s` (at least
one). Two rates: every video's length over the window (the one flow's,
paced by the host), and over the seconds in which the card ran a
kernel in the window (the card's: from a device trace of the whole
window, taken in the runs that report end-to-end metrics).

After the window the program is freed and the reference judges every
clip of the shortest video (scores and cut points; its float32
probabilities from set-up) and clips drawn from the seed out of the
longest (vcgbench/reference/chaptering.py). With `control`, the
reference one precision lower is judged in the program's place.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict

import numpy as np

from .. import flops, harness, weights
from ..gen import videos as gen_videos
from ..reference import chaptering, host, nets

def passes(traffic: dict, seconds: float) -> int:
    pool_s = float(sum(traffic["durations_s"]))
    return max(1, int(round(seconds * traffic["work_rate_s_per_s"]
                            / pool_s)))


def shift_for(logits: np.ndarray, target: float) -> float:
    """The shift of the positive logit that gives one video's clips
    (reference logits [n, 2]) the cut-point count nearest `target`."""
    margin = logits[:, 1] - logits[:, 0]
    best, best_err = 0.0, float("inf")
    for thr in np.quantile(margin, np.linspace(0.5, 0.995, 100)):
        n = len(host.cut_points((margin >= thr).astype(int).tolist()))
        if abs(n - target) < best_err:
            best, best_err = -float(thr), abs(n - target)
    return best


def meta_model(cfg: dict):
    import torch

    from video_chapter_generation_tpu_torch.models.bert import (
        BertConfig,
        BertModel,
    )
    from video_chapter_generation_tpu_torch.models.fusion import (
        TwoStreamWindow,
    )
    from video_chapter_generation_tpu_torch.models.resnet import ResNet

    v, h = cfg["vision"], cfg["head"]
    fields = BertConfig.__dataclass_fields__
    bert = BertConfig(**{k: x for k, x in cfg["bert"].items()
                         if k in fields})
    with torch.device("meta"):
        return TwoStreamWindow(
            BertModel(bert),
            ResNet(50, n_segment=v["n_segment"], n_div=v["n_div"],
                   stem_input=v["stem_input"], stage_sizes=v["stage_sizes"],
                   dtype=torch.bfloat16, tsm_impl=v["tsm_impl"]),
            window_size=h["window_size"], segment_size=v["n_segment"],
            hidden_size=h["hidden_size"], head_type=h["head_type"],
            dtype=torch.bfloat16, dropout=h["dropout"])


def made_weights(cfg: dict, seed: int, device, delta: float = 0.0):
    """The window model's state dict as served, from the seed: the
    trunk's parameters in float32 (folded and cast by the program), the
    rest bf16; the classifier's positive bias shifted by delta."""
    import torch

    sd = weights.make(weights.shapes_of(meta_model(cfg)), seed, 3, device,
                      lambda k: torch.float32
                      if k.startswith("vision_model.") else torch.bfloat16)
    b = sd["window_attn.classifier.bias"]
    b[1] = (b[1].float() + delta).to(b.dtype)
    return sd


class Reference:
    """The plain reference over the seed's weights (float32 copies) and
    the raw inputs on disk."""

    def __init__(self, cfg, traffic, seed, dev, frames_root, delta=0.0):
        self.sd = weights.as_float32(made_weights(cfg, seed, dev, delta))
        self.cfg, self.traffic, self.dev = cfg, traffic, dev
        self.frames_root = str(frames_root)
        self.word_id = {w: i for i, w in
                        enumerate(gen_videos.words(traffic["vocab_words"]))}

    def logits(self, video, precs=(nets.FP32,), rows=None):
        with nets.exact_matmuls():
            return chaptering.video_logits(
                self.sd, self.cfg, video, self.frames_root, self.word_id,
                self.traffic["frame_hw"], self.dev,
                self.cfg["serving"]["score_batch"], precs, rows)


class WindowScoreSystem:
    """The program: eval_segment's scoring of whole videos."""

    def __init__(self, cfg, traffic, sd, dev, pool, frames_root):
        from video_chapter_generation_tpu_torch.core.metrics import (
            StepTimer,
        )
        from video_chapter_generation_tpu_torch.data.clip_grid import (
            flatten_video_to_clips,
        )
        from video_chapter_generation_tpu_torch.data.datasets import (
            InferWindowClipDataset,
        )
        from video_chapter_generation_tpu_torch.data.tokenization import (
            WordPieceTokenizer,
        )
        from video_chapter_generation_tpu_torch.evalkit.boundary import (
            convert_clip_label2cut_point,
        )
        from video_chapter_generation_tpu_torch.pipeline import (
            make_window_score_fn,
            score_clips,
        )

        self.StepTimer = StepTimer
        self.timer = StepTimer()
        self.tracer = None
        corpus = gen_videos.corpus(pool, frames_root)
        tok = WordPieceTokenizer(gen_videos.bert_vocab(
            gen_videos.words(traffic["vocab_words"])))
        model = meta_model(cfg)
        model.load_state_dict(sd, assign=True)
        model.to_serving(dev)
        self.model = model
        inner = make_window_score_fn(model, dev)

        def score_fn(batch):
            if self.tracer is not None:
                self.tracer.tick()
            return inner(batch)

        sv, t = cfg["serving"], cfg["vision"]["n_segment"]

        def score_video(vid):
            clips = flatten_video_to_clips(
                vid, corpus.img_dir, corpus.image_num(vid),
                corpus.raw_cut_secs(vid), corpus.subtitles(vid), t)
            ds = InferWindowClipDataset(
                clips, tok, t, sv["max_text_len"],
                window_size=cfg["head"]["window_size"], mode="all",
                hw=traffic["frame_hw"])
            infos = score_clips(ds, score_fn, sv["score_batch"], self.timer)
            cuts = convert_clip_label2cut_point(
                [c.pred_label for c in infos], t, 2)
            return [c.pred_score for c in infos], list(cuts)

        self.score_video = score_video
        self.videos: Dict[str, dict] = {}
        self.clips = self.finished = 0

    def run(self, vids) -> None:
        """Score whole videos in order; keep each one's scores and cuts."""
        self.timer = self.StepTimer()
        for vid in vids:
            self.timer.start("video_total")
            scores, cuts = self.score_video(vid)
            self.timer.stop("video_total", 1)
            self.videos[vid] = {"scores": scores, "cuts": cuts}
            self.clips += len(scores)
            self.finished += 1


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        t0: float, device_name: str = "cuda", control: bool = False,
        cache: Path = harness.CACHE) -> dict:
    import torch

    cfg, traffic = cell.config, cell.traffic
    torch.set_num_threads(1)
    dev = torch.device(device_name)
    frames_root = gen_videos.frame_library(
        cache / "frames", traffic["durations_s"], traffic["frame_hw"],
        traffic["jpeg_quality"])
    pool = gen_videos.pool(traffic, seed)
    warm = min(pool, key=lambda v: v["duration"])

    # the head's shift, from the reference's scores of the warm video
    ref = Reference(cfg, traffic, seed, dev, frames_root)
    warm_logits = ref.logits(warm)[0]
    b1 = float(ref.sd["window_attn.classifier.bias"][1])
    target = (traffic["chapters_per_video"] * warm["duration"]
              / float(np.mean(traffic["durations_s"])))
    delta = shift_for(warm_logits, target)
    del ref
    sd = made_weights(cfg, seed, dev, delta)
    b1_shifted = float(sd["window_attn.classifier.bias"][1].float())
    warm_logits[:, 1] += b1_shifted - b1
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    system = WindowScoreSystem(cfg, traffic, sd, dev, pool, frames_root)
    del sd
    system.score_video(warm["vid"])
    todo = [v["vid"] for v in pool] * passes(traffic, seconds)
    whole = None if trace else harness.WholeWindowTrace(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    host0 = harness.host_usage()
    t_start_ns = time.time_ns()
    t_start = t_start_ns / 1e9
    tracer = harness.TraceWindow(traffic["trace"], t_start, dev) \
        if trace else None
    system.tracer = tracer
    system.run(todo)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_end_ns = time.time_ns()
    t_end = t_end_ns / 1e9
    host1 = harness.host_usage()
    busy = whole.busy(t_start_ns, t_end_ns) if whole else {}
    peak = int(torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else 0)
    traced = tracer.summary() if tracer else {}
    window = t_end - t_start
    secs = {v["vid"]: v["duration"] for v in pool}
    v = cfg["vision"]
    w = 2 * cfg["head"]["window_size"] + 1
    video_s = sum(secs[vid] for vid in todo)
    out = {"attempted": len(todo), "failed": len(todo) - system.finished,
           "window_s": window, "setup_s": t_start - t0,
           "video_s_per_s": video_s / window, "peak": peak, **busy,
           **{k: host1[k] - host0[k] for k in host1}}
    if busy.get("kernel_busy_s"):
        out["video_s_per_card_s"] = video_s / busy["kernel_busy_s"]
    out["ctx"] = {
        "window_s": window, "video_s": video_s,
        "timer": system.timer.summary(),
        "clips": system.clips,
        "trunk_call_bound_s": flops.trunk_bound_s(
            cfg["serving"]["score_batch"] * w * v["n_segment"],
            traffic["frame_hw"], v["stage_sizes"],
            stem_input=v["stem_input"]),
        "clip_flops": flops.window_sample_flops(cfg, traffic["frame_hw"]),
        **traced}
    served = system.videos
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"], out["readings"] = judge(
        cfg, traffic, seed, pool, served, frames_root, dev, delta,
        warm_logits, control, cell.limits)
    return out


def judge(cfg, traffic, seed, pool, served, frames_root, dev, delta,
          warm_logits, control, limits):
    """The reference over every target clip of the shortest video (scores
    and cut points) and `sample_clips` clips drawn from the seed out of
    the longest (scores) -> (checks, readings). With `control`, the
    reference in fp8 is what is judged, in the program's place."""
    by_len = sorted(pool, key=lambda v: (v["duration"], v["vid"]))
    short, long_ = by_len[0], by_len[-1]
    if short["vid"] not in served or long_["vid"] not in served:
        return [harness.check("videos_finished", 0.0, -1.0)], {}
    t0 = time.time()
    ref = Reference(cfg, traffic, seed, dev, frames_root, delta)
    precs = [nets.FP32] + ([nets.Prec("fp8")] if control else [])
    n_long = len(served[long_["vid"]]["scores"])
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    rows = np.sort(rng.choice(n_long, min(traffic["sample_clips"], n_long),
                              replace=False))
    ref_short = chaptering.probs(warm_logits)
    ref_long = [chaptering.probs(x) for x in ref.logits(long_, precs, rows)]
    prog_short = np.asarray(served[short["vid"]]["scores"], np.float64)
    prog_cuts = served[short["vid"]]["cuts"]
    prog_long = np.asarray(served[long_["vid"]]["scores"], np.float64)[rows]
    readings = _readings(prog_short, prog_cuts, ref_short, prog_long,
                         ref_long[0], limits)
    judged = readings
    if control:
        low_short = chaptering.probs(ref.logits(short, precs[1:])[0])
        judged = _readings(low_short, chaptering.cut_points(low_short),
                           ref_short, ref_long[1], ref_long[0], limits)
        readings.update({k + "_control": x for k, x in judged.items()})
    readings["reference_s"] = time.time() - t0
    readings["sample"] = {"cuts": short["vid"], "clips_of": long_["vid"],
                          "clips": int(len(rows)), "delta": delta}
    return ([harness.check(k, judged[k], limits[k])
             for k in ("score_gap", "cut_mismatch")], readings)


def _readings(p_short, cuts_short, ref_short, p_long, ref_long,
              limits) -> Dict[str, float]:
    """score_gap over both videos' judged clips, cut_mismatch of the
    short one."""
    r = chaptering.score_readings(p_short, ref_short, cuts_short,
                                  limits["score_gap"])
    return {"score_gap": max(r["score_gap"],
                             float(np.max(np.abs(p_long - ref_long)))),
            "cut_mismatch": r["cut_mismatch"]}
