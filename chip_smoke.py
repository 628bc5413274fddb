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
   and times both with CUDA events, each bottleneck beside its bound and
   its library yardstick (cuDNN F.conv2d per conv in channels_last bf16
   on a pre-shifted input, the affines as torch ops: timed, never a
   route); prints K2/K3's and K4's device time by conv and layer from
   one torch.profiler trace of the 16 blocks; then holds the whole trunk
   (kernels, bf16, on the card) against the plain float32 trunk on the
   CPU for one clip.
4. Runs ChapterPipeline.run(pipelined=True) with frame_pack=True over
   synthetic 300-s videos, with the head bias shifted so clip scores
   straddle 0.5 (as bench_pipeline.py does), and checks the launch
   counts (per vision call: stem 1, stride-1 bottleneck 13, stride-2
   bottleneck 3), finite scores, and at least one cut point and one
   title per video. Then times greedy title decode of Pegasus-large in
   bf16 and in --int8_titles' int8 form, same weights, batch and inputs,
   with one torch.profiler trace of each (information only).
5. The inference CLI (K8, K9). Holds the frames stem (`stem_frames`,
   bf16 frames [256, 224, 224, 3]: the decoded frames of one vision call;
   one launch, the pool fused) to its plain version beside its cuDNN
   yardstick, and the pool kernel (`bn_relu_maxpool`, on no model path)
   at its former shape, the conv output [256, 112, 112, 64], bit for bit,
   beside its torch sequence (the affine and ReLU in bf16, then
   F.max_pool2d);
   calibrates the full-width
   frames-stem trunk on the card and holds each of its 10 W8A8 blocks
   (`tsm_bottleneck_int8`) to its plain version, each fed the kernel
   output of the block before (int8 outputs equal, else at most one
   quantum on fewer than 1e-3 of the elements; bf16 outputs in the
   bands), timing beside them the bf16 K2/K3 launches of the same blocks
   and printing K9's device time by conv and layer (one torch.profiler
   trace); holds the int8 trunk to the bf16 kernel trunk on one clip
   (cosine >= 0.98 per frame) and checks that unit scales change it; then
   writes a checkpoint of the frames-stem model as train_segment does
   (the head bias shifted as in 4) and runs cli/infer_video.main with
   --int8_vision --int8_titles --pipelined over 2 synthetic videos,
   checking the launch counts (per vision call: normalize_frames 1,
   stem_frames 1, bn_relu_maxpool 0, tsm_bottleneck 3, tsm_bottleneck_s2
   3, tsm_bottleneck_int8 10, plus one bf16 calibration call), the restored
   checkpoint, and at least one cut point and one title per chapter for
   each video.
6. BigBird-Pegasus and BART titles (K10). Builds bigbird_pegasus_large
   (bf16, seeded random weights carried over as above) and holds
   `sparse_band_attention` to its plain version at the serving shape (B
   8, L 3072, H 16, hd 64, bs 64, 3 random blocks; q, k and v of encoder
   layer 0 on ids whose rows are valid for 300..3072 tokens), timing
   kernel, plain version, the library yardstick (SDPA with the
   equivalent float mask) and the bound, and two runs bit for bit (the
   serving shape takes the serving kernel); holds K10 the same way on
   the same bytes at the shapes that take its other two kernels (the
   ring kernel or the mma.sync kernel, as the shape's route says): q, k
   and v in bs-32 tables (94 x 8 table entries), as H 64 of hd 16 in
   bs-16 tables with one random block (the --tiny BigBird's block, head
   dim and P 6), in bs-48 tables, as H 32 of hd 32 and H 8 of hd 128 in
   bs-64 tables, and in bs-64 tables of 5 random blocks (P 10), each
   time checking that the route's kernel's counter moved and no other
   (each of the two held at one shape at least); holds the whole
   block-sparse attention on the card to its float32 form on the CPU for
   two rows; checks 16 K10 launches per encode, all on the serving
   kernel, and greedy-generates 30 tokens at batch 8 from 3072-token
   inputs; runs cli/infer_video.main with --title_arch bigbird
   data.title_input_len=3072 --pipelined from the checkpoint of phase 5,
   checking 16 K10 launches per title batch, all on the serving kernel,
   and a title per chapter; then one greedy generate of BART-large.
7. Training. Holds every training kernel entry (the K11 stem, the K12
   bottleneck of each kind forward and backward with its finale, and the
   K13 trunk's links and recomputation of p) against its plain PyTorch
   version at every shape of one full-width step (8 clips x 16 frames =
   128 frames at 224 px, bf16), with the forward output, the batch
   statistics and every gradient compared and both timed (K11 and each
   K12 block also beside its cuDNN sequence through autograd, and two of
   K11's runs bit for bit); holds each
   link bit for bit to what the per-block chain computes there, and the
   trunk Function's forward bit for bit to the chain of per-block
   Functions, its gradients in the bands, two of its runs bit for bit,
   and checks that it keeps no p; prints K12's device time a step by
   kernel (each conv's forward GEMM, dgrad, wgrad, the BN-vector and
   reduction kernels, the finale) from one torch.profiler trace of each
   direction over one call of every block; then trains the port's
   cli/train_segment on a synthetic corpus for a few AdamW steps
   (BERT-base, ResNet50-TSM s2d, mlp head, data.batch_size=8) and checks
   finite losses, moved parameters and BN running statistics, exact
   kernel launch counts per step (the finale and its backward once, 15
   links each way) and a checkpoint that restores. Then
   model.remat_vision: one vision step with every block checkpointed,
   bit for bit the per-block chain, peak memory beside the chain's and
   the fused trunk's, and 2 train_segment steps with remat on.
8. The window model (K5, K6, K7). Holds K5 (`tsm_conv1x1_bn_relu` and
   the epilogue-free `tsm_conv1x1`) to its plain version at the conv1 of
   all 16 blocks of one 256-frame vision call, beside torch.matmul of the
   same product on a pre-shifted input (the GEMM part alone), and K5's
   training backward at one 128-frame step in the gradient bands; K7
   forward and reverse at every block input and K6 at [16, 16, 224, 224,
   3] to float32 and bf16, both bit for bit. Then runs cli/train_segment
   .main on the default config (model.kind two_stream_window: BERT-base,
   ResNet50-TSM frames stem, bf16, hidden 128, W = 3) for 3 steps of 2
   windows under tsm_impl auto (with its AUC/mAP eval) and pallas,
   checking the launch counts per step, a finite loss, moved parameters
   and BN statistics and the checkpoint; and scores one synthetic video
   through build_score_fn with InferWindowClipDataset under auto,
   fusedblk, pallas and fuse_tsm=False, checking launches per vision call
   (K2/K3 13 and K4 3; K2 12 and K5 4; K5 16; K7 16; each with K6 1 and
   the frames stem), probabilities in [0, 1], the restored checkpoint,
   and each trunk against the auto trunk on one clip.
9. int8_s2 (K14a, K14b). Holds the W8A8 stride-2 block0
   (`tsm_bottleneck_s2_planar_int8`) to its plain version at the three
   block0 shapes of a 256-frame vision call of the s2d serving trunk,
   calibrated on the card, with models/resnet.py INT8_S2_BLOCKS on (int8
   outputs equal, else one quantum apart on fewer than 1e-3 of them; its
   bf16 output mode on the same inputs in the bf16 bands), each
   block fed the kernel output of the block before, and the int8 stem
   (`stem_s2d_int8`) to its plain version bit for bit at [256, 56, 56,
   48] (one launch a call, no pool launch, two runs bit for bit, K1's
   time on the same frames beside it), timing K4 on the same block0s
   beside K14a; then runs the vision call with the switch (per call:
   stem 1,
   stride-1 bf16 bottleneck 3, K14a 3, K9 10, K4 0; per-frame cosine >=
   0.98 to the bf16 trunk) and cli/infer_video.main --int8_vision
   --pipelined with the switch on from the checkpoint of phase 5 (the
   same counts per vision call plus the bf16 calibration call; a cut
   point and a title per chapter).
10. chain (K15). Holds `tsm_bottleneck_chain` at the four stage chains of
   a 256-frame vision call (layer1 blocks 1-2 ... layer4 blocks 1-2) to
   its plain version (bf16 bands) and bit for bit to the per-block K2/K3
   launches, and `tsm_bottleneck_halo_chain` bit for bit to it, timing
   the chain, the per-block sequence, the plain version and the blocks'
   library yardsticks; then runs
   the vision call with chain_blocks=True (per call: stem 1, K2/K3 1, K4
   3, K15 4) and checks its features equal chain_blocks=False.
11. wide (frames wider than 256 px: the stems' walk in column chunks).
   At 320 and 260 px (80 and 65 cells a row; 65 is odd, with a chunk
   seam), 8 seeded random frames each and the serving model's stem
   weights, holds K1 (`stem_s2d`) and K8 (`stem_frames`) to their plain
   versions in the bf16 bands, K11 through `stem_s2d_train` and
   `stem_frames_train` (output and statistics in the bf16 bands,
   gradients in the gradient bands) and K14b bit for bit (one launch,
   two runs bit for bit).
12. vision_titles (the extraction entry point, vision-conditioned beam
   titles). Runs cli/extract_vision_emb at 224 px over the 16-frame clips
   of phase 5's corpus, 16 clips a call: in bf16 (the s2d stem; per call
   K1 1, K2/K3 13, K4 3) and with --int8 (per call K1 1, K2/K3 3, K4 3,
   K9 10, plus one bf16 calibration call), each launch count exact and
   frames/s printed; holds the first clip's bf16 embeddings to the float32
   plain trunk on the CPU (per-frame cosine >= 0.99) and every int8 one to
   the bf16 one (>= 0.98). Then runs cli/infer_video.main --vision_emb_dir
   (the bf16 embeddings) --fusion_type cross_attn --num_beams 4
   --pipelined from phase 5's checkpoint (Pegasus-large titles, seeded
   random weights; the boundary model's launches counted), a title per
   chapter; on the title inputs of its first call, one beam equals greedy
   bit for bit, each beam-4 score equals the teacher-forced,
   length-normalised log-prob of its ids within 1e-2 (teacher-forced in
   the search's batch layout and at the title batch alone), and greedy and
   beam-4 decode are timed (ms a step). Adds the extraction paths' K1,
   K2/K3, K4 and K9 entries to the kernels line ("path" names the entry
   point), with the serving and inference entries' times at the same
   shapes and this phase's launches.
13. title_training (cli/train_title). Pegasus-large at the JAX CLI's
   defaults (bf16, data.batch_size=16, 512 -> 30 tokens) on a synthetic
   corpus whose piece table is padded to Pegasus-large's 96,103 entries:
   10 epochs of 4 optimizer steps and the eval, finite losses, moved
   parameters, a
   checkpoint with an eval score; gradient_accumulation_steps=2 over two
   batches of 8 rows of equal decoder length (float32, dropout off)
   against one update over the 16 (the gradient each update clips within
   1e-3 relative norm, cosine of the parameters' change >= 0.999); one
   bf16 step with remat and one without on the same batch and dropout
   seed (equal losses, gradients' cosine >= 0.9999, peak memory of each);
   cli/infer_video restoring that checkpoint beside phase 5's boundary
   checkpoint in one directory and titling every chapter from it; then 2
   steps each of the vision-conditioned model (phase 12's embeddings,
   cross_attn), BigBird-Pegasus-large at 3072 tokens (batch 2; K10: no
   launch in its training steps, 16 in its eval batch) and BART-large
   (batch 2), whose saves are recorded (an eval score each) but not
   written. K10 is held to its plain version, and timed, on the inputs of
   its first launch in the BigBird eval (encoder layer 0 of the eval
   batch, its real mask): that entry of the kernels line. Each run prints
   ms a step, tokens/s, peak memory and its set-up time.
14. evaluation (the offline chain). datasetkit/flatten over the
   inference corpus (2 videos of 120 s at 224 px); cli/eval_segment on
   the window model from phase 8's auto checkpoint (per vision call K6
   1, the frames stem 1, K2/K3 13, K4 3); cli/eval_segment on the
   frames-stem two-stream model from phase 5's checkpoint in bf16 and
   with --int8_vision (K9 10 a call plus the bf16 calibration call), mAP
   and F1@3 of both printed; cli/eval_title on Pegasus-large from phase
   13's checkpoint as it was written, with --location gt, then
   --location pred on the window model's vid2cut_points.json with
   --num_beams 4: restored checkpoints, finite metrics, both result
   files, the CLI's ids of its first title batch (before the trim at
   EOS; greedy, then beam 4) equal to a direct generate / beam_search of
   the same checkpoint restored by this script on the same inputs, its
   titles the decoded ids, a non-empty title per chapter and the title
   file's 12 ROUGE lines; cli/eval_title --title_arch bigbird
   data.title_input_len=3072 (seeded weights: no BigBird checkpoint is
   kept), 16 K10 launches an encode, two encodes a title batch (the
   teacher-forced forward and the generate). Every kernel of these paths
   is held to its plain version, and timed, on the arguments of the
   path's own first vision call (192 frames of the window model, 256 of
   the two-stream model in bf16, whose clips the int8 run calibrates on,
   and of its W8A8 blocks) or, K10, of its first launch (the eval batch's
   real mask). Each step's wall time, device_score and
   title_generate are printed; the kernels line gains this phase's paths
   with those numbers and this phase's launches.
15. pretrain_lang. cli/pretrain_lang --task mlm at BERT-base width (the
   synthetic corpus's vocabulary padded to BERT-base's 30,522; batch 8,
   100 tokens, bf16) for 3 steps: finite losses, moved parameters, a
   checkpoint that restores; ms a step printed.
16. parallel (after 8, from the checkpoints of 5 and 8). Prints the card
   count and make_mesh()'s shape; runs cli/infer_video --sharded with
   phase 5's argv (--int8_vision --int8_titles --pipelined): on one card
   a one-shard mesh, so each video's cut points and titles and the launch
   counts equal phase 5's; scores phase 8's window model with
   make_sharded_window_score_fn on two shards of the one card, 16 windows
   a call, against the one-shard scorer (scores within 1e-2, labels equal
   away from the threshold, launches a call K6 2, K8 2, K2/K3 26, K4 6),
   holding those kernels to their plain versions on the first shard's
   arguments; spawns two processes of cli/infer_video with the launcher's
   environment (gloo on the shared card; NCCL where each has a card):
   each serves vids[rank::2] and the first prints the merged lines, equal
   to the sharded run's; and checks NCCL at world 1 (the object
   collectives, a barrier, an all_reduce on the card) in a process of
   its own. Each step's wall time, device_score and title_generate.
17. gpt. cli/pretrain_lang --task next_token_gpt (12 layers, 10 heads,
   300 wide) and --task next_token_glove (12 heads over a random 300-d
   GloVe text file written for the corpus's words), over the corpus's
   words padded to 10,000 (--glove_vocab), 3 steps each at
   batch 8 x 100 tokens in bf16: finite losses, moved parameters, the
   checkpoint's contract; cli/sample_lang on each checkpoint (2 prompts
   x 2 samples of 20 tokens, top-k 10): two greedy runs equal, two
   seeded sampled runs equal; ms a step printed.
18. variants (the secondary models and tools; ~45 s). TwoStreamDomainSpecific
   at full width (BERT-base, ResNet50-TSM frames stem T 16, window 1,
   hidden 128, bf16, seeded weights through the from_jax tables): one
   serving call of 2 windows (96 frames at 224 px; launches exact: K8 1,
   K2/K3 13, K4 3), each kernel held to its plain version on that call's
   own arguments; 2 training steps under make_grouped_optimizer (K11,
   K12 and K13 launches exact each step, finite losses, every parameter
   but the attention key biases and the BN means moved);
   SingleBlockWindowClassifier on seeded features against its float32
   CPU run; cli/pretrain_contrastive (BERT-base, K 65,536, batch 8 x 100
   tokens, 3 steps: queue_ptr 24, enqueued keys of norm 1, the key
   encoder m k + (1 - m) q at each step within bf16 rounding) and
   cli/train_listwise (slates of 6 x 100 tokens, batch 4, 3 steps), ms a
   step printed; Grad-CAM at layer 4 on 16 frames of 224 px (launches
   exact, its kernels held on the capture call's arguments, the cam in
   [0, 1] and within cosine 0.99 of the plain float32 trunk's on the CPU;
   a re-entry at stage 3 under tsm_impl auto raises, naming "tap3" and
   "xla"); saliency and integrated gradients (16 steps) on BERT-base
   (rows sum to 1, pads 0); cli/convert_weights two_stream_window on a
   full-width reference-layout checkpoint made from seeded arrays (the
   state dict and the scores bit for bit the source model's);
   utils/profiling.device_trace writes a trace and
   utils/memory.device_memory_mb reads the allocation. Its kernels-line
   entries carry "path": the serving and Grad-CAM calls' own numbers, the
   training steps' launches beside the training phase's numbers (its
   128-frame step).
19. hf_import (right after 6, on its BigBird model; ~3 s). ResNet-50
   (frames stem, T 16, bf16, seeded weights) renamed into HF
   ResNetModel's keys (resnet_to_hf) and imported back by
   models/convert_hf.py:convert_hf_resnet: the same state dict, a strict
   load, and one 16-frame vision call (K8 1, K2/K3 13, K4 3, exact) bit
   for bit the torchvision-layout trunk's, its kernels held on that
   call's arguments; phase 6's BigBird-Pegasus-large renamed into HF
   BigBirdPegasus's keys (bigbird_to_hf) and imported back by
   convert_hf_seq2seq: a strict load, and its encode of phase 6's 3072
   tokens (16 K10 launches, all on the serving kernel) bit for bit
   phase 6's encoder states, K10 held on its first launch. Its
   kernels-line entries carry "path".
20. datasetkit (the last; the host only; ~25 s). A synthetic scrape of
   2,000 videos in 10 query directories (synth_scrape) through topics,
   merge, filtering, split, data/corpus.py, the ROUGE easy/hard split,
   sampler and stats; every merged row passes keep_video, the split
   files partition the merged vids, the corpus reads them back, and each
   gated stage whose dependency is missing raises its RuntimeError (the
   dependencies found are printed).
21. Prints one JSON line of the kernels (a bound over several shapes
   is the sum of each shape's), the wall time of each phase
   and of the script and, last, the device line. The title decode of 4
   and each of 5-20 also print their wall time as they end ("serving",
   1-4 up to the title decode, prints only on that line).

After the serving path (4), the native_decode phase: where the machine
has g++ and jpeglib.h (checked before any build; where it lacks them a
line says so and nothing runs), builds native/vcg_host.cc into the
package's build directory, holds its s2d decode of one video's frames
bit for bit to PIL plus the numpy s2d pack (frames/s of both printed),
and runs ChapterPipeline on that video with the native decoder
installed: clip scores and cut points bit for bit the PIL run's, K1-K4
launches exact (their kernels-line entries carry "path").

Any failed phase raises, and the script exits non-zero without printing
the final line; it also fails where CUDA is absent or the package is
not beside it.

    python3 chip_smoke.py --time-kernels [--root CHECKOUT]

times K1, K8, K9, K14a and K14b alone (and their yardsticks: cuDNN for
the stems, the bf16 K2/K3 and K4 launches of the same blocks) at the
shapes of one 256-frame vision call, K6 on the frames of one 16-clip call
(beside torch.addcmul), K11's two entries at one training step's shape
(beside its cuDNN sequence through autograd, and split by pass), K10
at the BigBird-Pegasus serving shape (beside SDPA with its float mask)
and at its other held shapes (phase 6's), each of its kernels at each
class of block size and head dim, and the pool kernel
at its held shape (beside its torch sequence), with K6's, K14b's and
K10's device time by kernel, on the package of
CHECKOUT (default: beside this script), seeded random weights, frames
and attention inputs; one JSON line. Two trees are compared within one
call by running it on each in turns.
"""

import contextlib
import io
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
# H100 SXM published peaks (dense bf16, dense int8, HBM3), for the bounds
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_HBM_BYTES = 989e12, 1979e12, 3.35e12
# the inference CLI's end-to-end phase: synthetic videos and their length
INFER_VIDEOS, INFER_SEC = 2, 120
# the W8A8 trunk vs the bf16 kernel trunk on one clip, per frame
INT8_TRUNK_MIN_COS = 0.98
# BigBird-Pegasus titles: the serving input length (the JAX CLI's advice
# for --title_arch bigbird), batch, and the padded lengths of the K10 rows
BIGBIRD_IN, BIGBIRD_BATCH = 3072, 8
BIGBIRD_MIN_LEN = 300
# K10 at the shapes other than the serving one (the ring or the mma.sync
# kernel, as its route says), held on the serving layer's q, k and v (B 8,
# L 3072, 1024 wide): (label, block size, heads, random blocks); the first
# a kernel takes is its kernels-line row
K10_OTHER_SHAPES = [
    ("bs 32 (94 x 8 table entries)", 32, 16, 3),
    ("bs 16, hd 16, P 6 (--tiny's)", 16, 64, 1),
    ("bs 48", 48, 16, 3),
    ("bs 64, hd 32", 64, 32, 3),
    ("bs 64, hd 128", 64, 8, 3),
    ("bs 64, P 10", 64, 16, 5)]
# --time-kernels times the ring and the mma.sync kernel at each class of
# these block sizes and head dims (P 8, H 1024 // hd), for K10's route
K10_ROUTE_BS, K10_ROUTE_HD = (16, 32, 48, 64), (16, 32, 48, 64, 80, 96, 112,
                                                 128)
# the window model: training steps of 2 windows (3 clips x 16 frames each)
# per tsm_impl, and the scoring batch (4 windows: 192 frames a vision call)
WINDOW_STEPS, WINDOW_BATCH = 3, 4
# each non-auto vision trunk vs the auto kernel trunk on one clip, per
# frame: the same function, rounded to bf16 at other places
WINDOW_TRUNK_MIN_COS = 0.99
# frames a width of the wide-frame phase, and its widths in px
WIDE_FRAMES, WIDE_PX = 8, (320, 260)
# vision-conditioned titles: beams (the JAX CLI's documented setting), and
# how far a returned beam score may lie from the teacher-forced,
# length-normalised log-prob of its ids, taken in the search's batch
# layout (the same bf16 products) and at the title batch alone (other
# GEMM shapes: bf16 rounds at other places)
BEAMS, BEAM_SCORE_TOL = 4, 1e-2
# title training at the JAX CLI's defaults (Pegasus-large, bf16, 512 -> 30
# tokens, batch 16), TITLE_EPOCHS epochs of TITLE_STEPS optimizer steps
# (after one epoch the greedy titles are EOS or the word boundary alone:
# all empty), the synthetic corpus's piece table padded to Pegasus-large's
# vocabulary; the smaller runs (vision-conditioned, BigBird at BIGBIRD_IN
# tokens, BART) at batch 2
TITLE_BATCH, TITLE_STEPS, PEGASUS_VOCAB, SMALL_BATCH = 16, 4, 96103, 2
TITLE_EPOCHS = 10
# accumulation over batches A and B (float32, dropout off) against one
# update over both: the gradient the update takes (before the clip),
# relative norm of the difference (a sum of the two gradients, or a mean
# over the wrong count, is 0.5 or more away), and cosine of the
# parameters' change; remat against none (bf16, dropout on, one generator
# seed): equal losses, cosine of the gradients
ACCUM_MAX_GRAD_REL, ACCUM_MIN_COS, REMAT_MIN_COS, ACCUM_ROWS = \
    1e-3, 0.999, 0.9999, 8
# BERT subtitle pretraining: BERT-base's vocabulary (the synthetic
# corpus's padded to it)
BERT_VOCAB = 30522
# the parallel phase: the window scorer's batch (windows of 3 clips) on a
# mesh of two shards; how far a sharded score may lie from the unsharded
# one (the bf16 kernels are row-local, but BERT's cuBLAS products may take
# another algorithm at half the rows); each launcher process's time limit
PARALLEL_BATCH, PARALLEL_SCORE_TOL, PARALLEL_RANK_TIMEOUT = 16, 1e-2, 420
# the from-scratch GPT's word vocabulary (the JAX GPTConfig's default; the
# synthetic corpus's few words padded to it)
GPT_VOCAB = 10000
# the data_parallel phase: the global batch of its train_segment runs
# (clips of CLIP_FRAMES frames; half a process) and of its Pegasus-large
# train_title runs (chapters); the cosine against one process that a
# 2-process run's BN running averages and title optimizer state (smooth
# in the gradients) and its title parameters' update (Adam's first steps
# are near lr * sign(gradient): a gradient near zero may flip sign under
# another bf16 rounding; measured 0.9996) must reach; the largest share of
# one process's optimizer state a process may keep under ZeRO (half, and
# the entries left whole); each process's time limit
DP_CLIPS, DP_TITLE_BATCH = 8, 8
DP_MIN_COS, DP_MIN_UPDATE_COS, DP_MAX_STATE_SHARE = 0.999, 0.995, 0.55
DP_RANK_TIMEOUT = 420
# the 2-process segment run against one process in bf16: the first
# micro-step's loss (relative), the AdamW moments of the text stream and
# the head (the plain route of one process lands 0.9987-0.9998 from the
# kernels'), and how far below the one process's plain route the vision
# trunk's moments may land (two valid one-process routes differ there at
# cosine 0.12-0.66 a stage: batch-stat BN amplifies bf16 rounding)
DP_LOSS_REL, DP_MIN_GRAD_COS, DP_VISION_SLACK = 1e-2, 0.998, 0.1
# a trunk's gradients against its plain version: batch-stat BN over the
# blocks amplifies the two versions' rounding differences past one
# block's bands (tests/test_torch_kernels_cuda.py:test_trunk_train_kernel
# holds the same); each block and the trunk against the chain of blocks
# are held to the gradient bands
TRUNK_GRAD_MIN_COS = 0.99
# the variants phase: TwoStreamDomainSpecific's windows (3 clips each) and
# training steps; the text CLIs' steps, MoCo's batch (its queue of 65,536
# fills by MOCO_BATCH a step) and the listwise slates a batch; the cam's
# cosine to the plain float32 trunk's; integrated gradients' steps
VARIANTS_SEED, DS_BATCH, VARIANT_TRAIN_STEPS = SEED + 41, 2, 2
VARIANT_CLI_STEPS, MOCO_BATCH, LISTWISE_BATCH = 3, 8, 4
CAM_MIN_COS, IG_STEPS = 0.99, 16
# the datasetkit phase: a synthetic scrape of DATASET_ROWS videos over
# DATASET_CATEGORIES search-query directories, the test-split videos its
# ROUGE easy/hard split takes; the hf_import phase's seed
DATASET_CATEGORIES, DATASET_ROWS, ROUGE_VIDS = 10, 2000, 4
HF_IMPORT_SEED = SEED + 53


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def compare(got, ref):
    """(max abs error, mean relative error, cosine), computed in float64
    (a float32 cosine over millions of elements can read above 1)."""
    import torch

    g, r = got.double().flatten(), ref.double().flatten()
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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least ms on the card for this work, what bounds it)."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def hold(entries, name, label, kernel, plain, flops, nbytes,
         exact_int=False, exact=False, library=None):
    """Run kernel and plain on the same inputs, hold the kernel to the plain
    version (exact_int: int8 outputs equal, or one quantum apart on fewer
    than 1e-3 of them; exact: bit for bit; else the bf16 bands), time both
    and add both times and the work to entries[name]; library, a yardstick
    giving the output NCHW, is timed too (into entries[name]["library_ms"])
    and its cosine to the kernel printed. Returns the kernel's output."""
    import torch

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    e = entries[name]
    if exact_int:  # int8 activations: count the quanta that differ
        diff = (got.int() - ref.int()).abs()
        n_diff, worst = int((diff != 0).sum()), int(diff.max())
        note = f"int8 differ {n_diff} of {diff.numel()} (max {worst})"
        e["max_abs"] = max(e["max_abs"], float(worst))
        ok = n_diff == 0 or (worst <= 1 and n_diff < 1e-3 * diff.numel())
    else:
        max_abs, mean_rel, cos = compare(got, ref)
        bitwise = torch.equal(got, ref)
        note = (f"max_abs {max_abs:.4g} mean_rel {mean_rel:.3g} cos "
                f"{cos:.6f} bitwise {bitwise}")
        e["max_abs"] = max(e["max_abs"], max_abs)
        ok = bitwise if exact else (cos >= KERNEL_MIN_COS
                                    and mean_rel <= KERNEL_MAX_MEAN_REL)
    k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
    e["ms"] += k_ms
    e["plain_ms"] += p_ms
    e["flops"] += flops
    e["bytes"] += nbytes
    if library is not None:
        l_ms = cuda_ms(library)
        l_cos = compare(library().permute(0, 2, 3, 1), got)[2]
        e["library_ms"] = e.get("library_ms", 0.0) + l_ms
        note += f" | library {l_ms:.3f} ms (cos {l_cos:.4f})"
    print(f"# {name:19s} {label:44s} {note} | kernel {k_ms:.3f} ms plain "
          f"{p_ms:.3f} ms", flush=True)
    if not ok:
        fail(f"{name} {label} disagrees with its plain version: {note}")
    return got


def bound_sum(parts, peak: float = PEAK_BF16_FLOPS):
    """The sum over parts [(flops, bytes)] of each part's bound, and what
    bounds the sum: the kind that bounds the parts holding the larger
    share of it (a per-block bound: one block bound by bytes and the next
    by operations each count at their own limit)."""
    total = by_ops = 0.0
    for flops, nbytes in parts:
        ms, by = bound(flops, nbytes, peak)
        total += ms
        by_ops += ms if by == "operations" else 0.0
    return total, "operations" if by_ops >= total - by_ops else "bytes"


def library_block(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, wp, sp, bp,
                  stride, t):
    """A serving bottleneck as a library sequence, a yardstick and never a
    route: cuDNN F.conv2d per conv in channels_last bf16 on a pre-shifted
    input, the folded-BN affines, residual and ReLUs as torch ops. Returns
    a function of no arguments giving the block's output (NCHW,
    channels_last)."""
    import torch
    import torch.nn.functional as F

    from video_chapter_generation_tpu_torch.ops.temporal_shift import (
        temporal_shift_reference,
    )

    bf = torch.bfloat16

    def oihw(w):
        w = w.reshape(1, 1, *w.shape) if w.dim() == 2 else w
        return w.permute(3, 2, 0, 1).to(bf).contiguous(
            memory_format=torch.channels_last)

    def vec(v):
        return v.to(bf).view(1, -1, 1, 1)

    xs = temporal_shift_reference(x, t, 8).permute(0, 3, 1, 2)
    xr = x.permute(0, 3, 1, 2)
    k1, k2, k3 = oihw(w1), oihw(w2), oihw(w3)
    v1, c1, v2, c2, v3, c3 = map(vec, (s1, b1, s2, b2, s3, b3))
    kp = None if wp is None else (oihw(wp), vec(sp), vec(bp))

    def run():
        y = torch.relu_(torch.addcmul(c1, F.conv2d(xs, k1), v1))
        y = torch.relu_(torch.addcmul(
            c2, F.conv2d(y, k2, stride=stride, padding=1), v2))
        y = torch.addcmul(c3, F.conv2d(y, k3), v3)
        res = xr if kp is None else torch.addcmul(
            kp[2], F.conv2d(xr, kp[0], stride=stride), kp[1])
        return torch.relu_(y.add_(res))

    return run


def library_stem(frames, w7, scale, bias):
    """The stem as a library sequence, a yardstick and never a route: cuDNN
    F.conv2d (7x7/2, pad 3) in channels_last bf16 on normalized NHWC
    frames, the folded-BN affine and the ReLU as torch ops, F.max_pool2d.
    Returns a function of no arguments giving the output (NCHW,
    channels_last)."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    x = frames.to(bf).permute(0, 3, 1, 2)  # NHWC memory: channels_last
    k = w7.permute(3, 2, 0, 1).to(bf).contiguous(
        memory_format=torch.channels_last)
    s, b = scale.to(bf).view(1, -1, 1, 1), bias.to(bf).view(1, -1, 1, 1)

    def run():
        y = torch.relu_(torch.addcmul(b, F.conv2d(x, k, stride=2, padding=3),
                                      s))
        return F.max_pool2d(y, 3, stride=2, padding=1)

    return run


def library_pool(x, scale, bias):
    """The pool kernel's yardstick, a library sequence and never a route:
    the folded-BN affine and the ReLU as torch ops in bf16 on NHWC x (as
    the stems' yardstick applies them), then F.max_pool2d (3x3/2, pad 1)
    in channels_last. Returns a function of no arguments giving the
    output (NCHW, channels_last)."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    xc = x.permute(0, 3, 1, 2)  # NHWC memory: channels_last
    s, b = scale.to(bf).view(1, -1, 1, 1), bias.to(bf).view(1, -1, 1, 1)

    def run():
        y = torch.relu_(torch.addcmul(b, xc, s))
        return F.max_pool2d(y, 3, stride=2, padding=1)

    return run


def library_block_train(x, params, stride, t, dy):
    """K12's yardstick, a library sequence and never a route: one training
    bottleneck as the temporal shift in torch ops, cuDNN F.conv2d per conv
    in channels_last bf16, F.batch_norm in training mode (batch
    statistics, float32 affine), ReLU, the projection and the residual,
    through torch autograd. params: the 12-slot (w1 w2 w3 wp g1 be1 g2 be2
    g3 be3 gp bep) form. Returns (forward, backward), functions of no
    arguments: the forward builds the graph of a step, the backward runs
    the gradient of dy [N, h, w, Co] to x and every weight, gamma and
    beta through one graph made ahead."""
    import torch
    import torch.nn.functional as F

    from video_chapter_generation_tpu_torch.ops.temporal_shift import (
        temporal_shift_reference,
    )

    bf = torch.bfloat16
    w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = params

    def oihw(w, k):
        w = w.detach().reshape(k, k, *w.shape[-2:])
        return w.permute(3, 2, 0, 1).to(bf).contiguous(
            memory_format=torch.channels_last).requires_grad_()

    def affine(v):
        return v.detach().float().clone().requires_grad_()

    xl = x.detach().clone().requires_grad_()
    k1, k2, k3 = oihw(w1, 1), oihw(w2, 3), oihw(w3, 1)
    bn = [affine(v) for v in (g1, be1, g2, be2, g3, be3)]
    kp = None if wp is None else (oihw(wp, 1), affine(gp), affine(bep))
    leaves = [xl, k1, k2, k3, *bn] + ([] if kp is None else list(kp))
    grad = dy.to(bf).permute(0, 3, 1, 2)

    def norm(y, g, b):
        return F.batch_norm(y, None, None, g, b, training=True, eps=1e-5)

    def forward():
        xs = temporal_shift_reference(xl, t, 8).permute(0, 3, 1, 2)
        y = torch.relu(norm(F.conv2d(xs, k1), bn[0], bn[1]))
        y = torch.relu(norm(F.conv2d(y, k2, stride=stride, padding=1),
                            bn[2], bn[3]))
        y = norm(F.conv2d(y, k3), bn[4], bn[5])
        xr = xl.permute(0, 3, 1, 2)
        res = xr if kp is None else norm(F.conv2d(xr, kp[0], stride=stride),
                                         kp[1], kp[2])
        return torch.relu(y + res)

    made = forward()

    def backward():
        return torch.autograd.grad(made, leaves, grad, retain_graph=True)

    return forward, backward


def library_stem_train(frames, w7, gamma, beta, dy):
    """K11's yardstick, a library sequence and never a route: cuDNN
    F.conv2d (7x7/2, pad 3) in channels_last bf16, F.batch_norm in
    training mode (batch statistics, float32 affine), ReLU and
    F.max_pool2d, through torch autograd. Returns (forward, backward),
    functions of no arguments: the forward builds the graph of a step,
    the backward runs the gradient of dy [N, h, w, 64] through one graph
    made ahead (weight, gamma, beta)."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    x = frames.to(bf).permute(0, 3, 1, 2)  # NHWC memory: channels_last
    k = w7.permute(3, 2, 0, 1).to(bf).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    g = gamma.float().clone().requires_grad_()
    b = beta.float().clone().requires_grad_()
    grad = dy.to(bf).permute(0, 3, 1, 2)

    def forward():
        y = F.conv2d(x, k, stride=2, padding=3)
        y = F.batch_norm(y, None, None, g, b, training=True, eps=1e-5)
        return F.max_pool2d(torch.relu(y), 3, stride=2, padding=1)

    made = forward()

    def backward():
        return torch.autograd.grad(made, [k, g, b], grad, retain_graph=True)

    return forward, backward


def sdpa_yardstick(q_mid, k, v, mask, tabs, bs):
    """K10's library yardstick, never a route: SDPA with a float mask, -inf
    outside each query block's attended key blocks and -10000 on attended
    padded keys (the same function while no random block collides with
    the window, which _random_block_map guarantees). Returns (a function
    of no arguments giving [B, H, nbq * bs, hd], the mask)."""
    import torch
    import torch.nn.functional as F

    dev = k.device
    ids_t, valid_t = tabs
    nbq, nb = ids_t.shape[0], k.shape[1] // bs
    blk = torch.zeros(nbq, nb, dtype=torch.bool, device=dev)
    on = valid_t.bool()
    blk[torch.arange(nbq, device=dev)[:, None].expand_as(ids_t)[on],
        ids_t.long()[on]] = True
    blk = blk.repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    pen = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    lib_mask = torch.where(blk[None, None], pen, float("-inf")).to(k.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q_mid, k, v))
    return (lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=lib_mask),
            lib_mask)


def traced_segments(fns):
    """The device kernel events of each of fns, from one torch.profiler
    trace of the fns run twice in order, the second pass read (a trace can
    miss its first launches); a fill kernel after each fn marks where its
    launches end. One list of events a fn, or fewer lists when the trace
    lost a mark."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sep = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            for fn in fns:
                fn()
                sep.zero_()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    segs, cur = [], []
    for e in kern:
        if "FillFunctor" in e.name:
            segs.append(cur)
            cur = []
        else:
            cur.append(e)
    return segs[-len(fns):] if len(segs) >= len(fns) else segs


def pass_split(runs):
    """Device ms of each kernel of each run [(label, fn)] (traced_segments).
    Information only; returns a printable string."""
    segs = traced_segments([fn for _, fn in runs])
    if len(segs) < len(runs):
        return f"not measured: {len(segs)} runs traced for {len(runs)}"

    def short(name):
        name = name.replace("(anonymous namespace)::", "")
        return name.split("(")[0].split("<")[0].split("::")[-1]

    parts = []
    for seg, (label, _) in zip(segs, runs):
        ms = [(short(e.name), e.time_range.elapsed_us() / 1e3) for e in seg]
        parts.append(f"{label} " + ", ".join(f"{k} {v:.3f}" for k, v in ms)
                     + f" (sum {sum(v for _, v in ms):.3f})")
    return "; ".join(parts)


def stem_parts(frames, w7, scale, bias):
    """K1's device time by part, from timing builds of csrc/stem_s2d.cu
    that leave one part out (VCG_STEM_SKIP: 1 the products, 2 the A-panel
    builds, 3 the epilogue with the pool), each timed on the same inputs
    with CUDA events: a part costs the full build's time less the build
    without it (the parts overlap, so the shares need not add up to the
    whole). Information only; returns a printable string."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from video_chapter_generation_tpu_torch.ops import _build
    from video_chapter_generation_tpu_torch.ops import stem as port_stem
    from video_chapter_generation_tpu_torch.ops.preprocess import norm_consts

    if not hasattr(port_stem, "stem_bands"):
        return "not measured (this tree has no part builds)"
    dev = frames.device
    n, hs, ws, _ = frames.shape
    wk = port_stem._phase_weight(w7, dev)
    sc, bi = scale.float().contiguous(), bias.float().contiguous()
    out = torch.empty(n, hs, ws, 64, dtype=torch.bfloat16, device=dev)
    bands = port_stem.stem_bands(
        n, hs, torch.cuda.get_device_properties(dev).multi_processor_count)
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(
            lambda k: _build.build_all(["stem_s2d"], (f"VCG_STEM_SKIP={k}",))[
                "stem_s2d"], range(4)))
    ms = []
    for path in libs:
        fn = ctypes.CDLL(str(path)).vcg_stem_s2d
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream
        ms.append(cuda_ms(lambda fn=fn: fn(
            frames.data_ptr(), wk.data_ptr(), sc.data_ptr(), bi.data_ptr(),
            norm_consts(dev).data_ptr(), out.data_ptr(), n, hs, ws, bands,
            stream)))
    return (f"kernel {ms[0]:.3f} ms: products {ms[0] - ms[1]:.3f}, A-panel "
            f"builds {ms[0] - ms[2]:.3f}, epilogue and pool "
            f"{ms[0] - ms[3]:.3f} (builds without each: {ms[1]:.3f}, "
            f"{ms[2]:.3f}, {ms[3]:.3f})")


def serving_split(runs, by_name=False):
    """Device ms of the bottleneck launches of a vision call by conv and
    layer, from traced_segments over runs [(layer, proj, fn)], one call of
    each block in call order; information only. Within a block they are
    conv1 (K5), [proj], conv2, conv3, or conv3+proj where conv3's tile
    runs the projection too (a kernel named pair_kernel), and a first
    launch that runs conv1 and the projection together (the earlier WMMA
    design, for comparing trees) is labelled conv1+proj. by_name (the W8A8
    blocks): each launch is labelled by its kernel's name (quantize,
    conv1, conv2, conv3)."""
    segs = traced_segments([fn for _, _, fn in runs])
    if len(segs) < len(runs):
        return (f"not measured: {len(segs)} runs of kernels traced for "
                f"{len(runs)} blocks")
    table, whole = {}, {}
    for seg, (layer, proj, _) in zip(segs, runs):
        if by_name:
            labels = tuple(next((k for k in ("quantize", "conv1", "conv2",
                                             "conv3") if k in e.name),
                                "other") for e in seg)
        elif len(seg) == 4:
            labels = ("conv1", "proj", "conv2", "conv3")
        elif len(seg) == 3 and proj and "pair" in seg[2].name:
            labels = ("conv1", "conv2", "conv3+proj")
        elif len(seg) == 3:
            labels = ("conv1+proj" if proj else "conv1", "conv2", "conv3")
        else:
            labels = tuple(f"launch{i}" for i in range(len(seg)))
        row = table.setdefault(layer, {})
        for e, lab in zip(seg, labels):
            ms = e.time_range.elapsed_us() / 1e3
            row[lab] = row.get(lab, 0.0) + ms
            whole[lab] = whole.get(lab, 0.0) + ms
    parts = [f"{layer} " + ", ".join(f"{k} {v:.3f}" for k, v in row.items())
             + f" (sum {sum(row.values()):.3f})"
             for layer, row in table.items()]
    parts.append("all " + ", ".join(f"{k} {v:.3f}" for k, v in whole.items())
                 + f" (sum {sum(whole.values()):.3f})")
    return "; ".join(parts)


def block_work(nt, h, w, c, f, co, stride, proj):
    """(forward flops, activation bytes in, weight count) of one
    bottleneck; the backward does twice the flops."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    m_in, m_out = nt * h * w, nt * ho * wo
    flops = 2 * (m_in * c * f + m_out * 9 * f * f + m_out * f * co
                 + (m_out * c * co if proj else 0))
    weights = c * f + 9 * f * f + f * co + (c * co if proj else 0)
    return flops, m_in, m_out, weights


TRAIN_KERNEL_SOURCES = {
    "stem_s2d_train_fwd": ("stem_train.cu", "stem_train_pallas.py:329"),
    "stem_s2d_train_bwd": ("stem_train.cu", "stem_train_pallas.py:329"),
    "stem_frames_train_fwd": ("stem_train.cu", "stem_train_pallas.py:359"),
    "stem_frames_train_bwd": ("stem_train.cu", "stem_train_pallas.py:359"),
    "tsm_block_train_fwd": ("conv_train.cu",
                            "tsm_block_train_pallas.py:1483"),
    "tsm_block_train_bwd": ("conv_train.cu",
                            "tsm_block_train_pallas.py:1483"),
    "tsm_trunk_train_finale_fwd": ("conv_train.cu",
                                   "tsm_trunk_train_pallas.py:118"),
    "tsm_trunk_train_finale_bwd": ("conv_train.cu",
                                   "tsm_trunk_train_pallas.py:118"),
    "tsm_trunk_train_link_fwd": ("conv_train.cu",
                                 "tsm_block_train_pallas.py:1027"),
    "tsm_trunk_train_link_bwd": ("conv_train.cu",
                                 "tsm_block_train_pallas.py:679"),
    "tsm_trunk_train_recompute_p": ("conv_train.cu",
                                    "tsm_trunk_train_pallas.py:118")}


def _train_entries(stem: str) -> dict:
    """Empty sums for the kernels of one training step, the stem's named
    after its input (s2d or frames)."""
    return {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "flops": 0.0,
                "bytes": 0.0, "max_abs": 0.0}
            for k in (f"stem_{stem}_train_fwd", f"stem_{stem}_train_bwd",
                      "tsm_block_train_fwd", "tsm_block_train_bwd",
                      "tsm_trunk_train_finale_fwd",
                      "tsm_trunk_train_finale_bwd",
                      "tsm_trunk_train_link_fwd",
                      "tsm_trunk_train_link_bwd",
                      "tsm_trunk_train_recompute_p")}


def train_kernel_rows(entries, launches, **extra):
    """The kernels-line entries of hold_train_kernels' sums, with these
    launches (by entry name) and any extra keys."""
    out = []
    for name, e in entries.items():
        src, replaces = TRAIN_KERNEL_SOURCES[name]
        b_ms, b_by = bound(e["flops"], e["bytes"])
        out.append(dict(
            name=name, route="cuda",
            source=f"video_chapter_generation_tpu_torch/csrc/{src}",
            replaces=f"video_chapter_generation_tpu/ops/{replaces}",
            launches=launches[name], max_abs_err=e["max_abs"], ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=e.get("library_ms"), **extra))
    return out


def _leaves(params):
    return [None if p is None else p.detach().clone().requires_grad_()
            for p in params]


def _block_fwd(x, st, t):
    """K12's forward entries and the finale of block st on x."""
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        block_train_fwd,
        finale_fwd,
    )

    stats, vec, saved = block_train_fwd(x, st.wf, st.gb, st.stride, t, 8,
                                        1e-5)
    finale_fwd(saved[2], saved[3] if st.proj else x, vec, st.f, st.co,
               st.proj)


def _block_bwd(x, st, dy, t):
    """The finale's backward prologue and K12's backward of block st."""
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        block_train_bwd,
    )

    dq, mom3 = st.finale_backward(dy)
    block_train_bwd(dq, mom3, x, st.saved, st.wb, st.gb, st.stats, st.vec,
                    st.stride, t, 8, 1e-5)


def hold_train_kernels(dev, gen, x_in, stem_w, blocks, kinds, t,
                       passes=None, library=False):
    """Every kernel of one training step of the vision trunk against its
    plain version, timed beside it, on these inputs: K11 on x_in (uint8
    s2d cells or bf16 frames) with stem_w (the HWIO 7x7 weight, gamma,
    beta); then K12 on each block (blocks: each block's train_params, of
    the kind in kinds), fed the kernel output of the one below, its
    finale and its p made again (K13), and from block 1 on K13's two
    links between it and the block below. passes, a list, gets (x, state,
    dy) of each block; with library, K12 is timed beside its cuDNN
    sequence through autograd (library_block_train) too. Returns (the
    entries' sums by kernel name, the stem kernel's output, the top
    block's output)."""
    import torch

    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        _StemTrain,
        _cells,
        _kernel_input,
        _stem_weight,
        stem_train_bwd,
        stem_train_fwd,
        stem_train_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        BlockTrainState,
        block_train_fwd,
        conv_nhwc,
        finale_fwd,
        finale_reference,
        trunk_link_bwd,
        trunk_link_bwd_reference,
        trunk_link_fwd,
        trunk_link_fwd_reference,
        tsm_block_train_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_trunk_train import (
        STRIDES,
        recompute_p,
        unpack,
    )

    bf = torch.bfloat16

    stem = "s2d" if x_in.dtype == torch.uint8 else "frames"
    entries = _train_entries(stem)

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

    def grad_of(y, wrt, dy):
        return torch.autograd.grad(y, [t for t in wrt if t is not None], dy,
                                   retain_graph=True)

    def link_phase(below, st, dy, label):
        """K13's two links between block `below` and block st (whose input
        is below's y) against their plain versions, and bit for bit
        against what the per-block chain computes there."""
        f, fb, cb = st.f, below.f, below.co
        p, r = below.saved[2], below.residual()
        aff = [below.vec[4 * fb + k * cb:4 * fb + (k + 1) * cb]
               for k in range(4)]
        sap_sbp = aff[2:] if below.proj else (None, None)
        x_l, u_l, mom_l = trunk_link_fwd(st, below)
        xr, ur, momr = trunk_link_fwd_reference(p, r, aff[0], aff[1],
                                                *sap_sbp, st.wf[0], t, 8)
        stats_l, _, _ = block_train_fwd(x_l, st.wf, st.gb, st.stride, t, 8,
                                        1e-5, linked=(u_l, mom_l))
        torch.cuda.synchronize()
        n_st = 4 * f + (4 if st.proj else 2) * st.co  # the slots written
        same = {"x": torch.equal(x_l, st.x),
                "u": torch.equal(u_l, st.saved[0]),
                "stats": torch.equal(stats_l[:n_st], st.stats[:n_st])}
        if not all(same.values()):
            fail(f"trunk_link_fwd {label}: not the chain's bit for bit: "
                 f"{same}")
        w_f = held("tsm_trunk_train_link_fwd", label,
                   [(x_l, xr), (u_l, ur), (mom_l[:2 * f], momr.flatten())])
        dq, mom3 = st.finale_backward(dy)
        dx_chain, _ = st.backward(dq, mom3)
        dq_c, mom3_c = below.finale_backward(dx_chain)
        res, _ = st.backward(dq, mom3, link=True)
        dq_l, mom3_l = trunk_link_bwd(st, below, res)
        a, e, fv = st.abc1.view(3, -1)
        du = (a * st.da1.float() + e * st.saved[0].float() + fv).to(bf)
        mup = (below.stats[4 * fb + 2 * cb:4 * fb + 3 * cb] if below.proj
               else None)

        def plain_bwd():
            return trunk_link_bwd_reference(
                du, st.wf[0], res, st.x, p, below.saved[3],
                below.stats[4 * fb:4 * fb + cb], mup, t, 8)

        dq_r, mom3_r = plain_bwd()
        torch.cuda.synchronize()
        if not torch.equal(dq_l, dq_c):
            fail(f"trunk_link_bwd {label}: dq is not the chain's bit for bit")
        nm = 3 if below.proj else 2
        w_b = held("tsm_trunk_train_link_bwd", label, [(dq_l, dq_r)])
        w_m = held("tsm_trunk_train_link_bwd", label,
                   [(mom3_l[k * cb:(k + 1) * cb], mom3_r[k])
                    for k in range(nm)]
                   + [(mom3_l[:nm * cb], mom3_c[:nm * cb])], True)
        # the same sums as the chain's finale backward in another order
        w_c = compare(mom3_l[:nm * cb], mom3_c[:nm * cb])
        kf = cuda_ms(lambda: trunk_link_fwd(st, below))
        pf = cuda_ms(lambda: trunk_link_fwd_reference(
            p, r, aff[0], aff[1], *sap_sbp, st.wf[0], t, 8))
        kb = cuda_ms(lambda: trunk_link_bwd(st, below, res))
        pb = cuda_ms(plain_bwd)
        m = st.x.numel() // cb
        account("tsm_trunk_train_link_fwd", kf, pf, 2 * m * cb * f,
                2 * (3 * m * cb + m * f + cb * f) + 16 * cb)
        account("tsm_trunk_train_link_bwd", kb, pb, 2 * m * cb * f,
                2 * ((4 if below.proj else 3) * m * cb + 2 * m * f + cb * f
                     + m * cb) + 12 * f + 8 * cb)
        print(f"# {'trunk links':18s} {label:44s} fwd x/u bitwise True, vs "
              f"plain cos {w_f[2]:.6f} | bwd dq bitwise True, vs plain cos "
              f"{w_b[2]:.6f}, moments cos {w_m[2]:.6f} mean_rel {w_m[1]:.3g} "
              f"(vs the chain's: mean_rel {w_c[1]:.3g}) | fwd kernel {kf:.3f} ms plain {pf:.3f} | bwd kernel "
              f"{kb:.3f} ms plain {pb:.3f}", flush=True)


    # --- K11: the training stem ---
    x0 = _kernel_input(x_in)
    u8 = x0.dtype == torch.uint8
    fwd_name, bwd_name = f"stem_{stem}_train_fwd", f"stem_{stem}_train_bwd"

    def stem_run():
        pk = _leaves(stem_w)
        y, mu, var = _StemTrain.apply(x0, *pk, 1e-5)
        return y, mu, var, pk

    y, mu, var, pk = stem_run()
    dy = torch.randn(y.shape, generator=gen, device=dev).to(bf)
    gk = grad_of(y, pk, dy)
    frames_n = normalize_frames(depth_to_space4(x0), bf) if u8 else x0
    pp = _leaves(stem_w)
    yr, (mur, varr) = stem_train_reference(frames_n, *pp)
    gr = grad_of(yr, pp, dy)
    torch.cuda.synchronize()
    w_out = held(fwd_name, "stem", [(y, yr), (mu, mur), (var, varr)])
    w_grad = held(bwd_name, "stem", list(zip(gk, gr)), True)
    # no float atomics: a second run agrees bit for bit
    y2, mu2, var2, pk2 = stem_run()
    gk2 = grad_of(y2, pk2, dy)
    same = (torch.equal(y, y2) and torch.equal(mu, mu2)
            and torch.equal(var, var2)
            and all(torch.equal(a, b) for a, b in zip(gk, gk2)))
    if not same:
        fail("two runs of the training stem differ")
    del y2, mu2, var2, pk2, gk2
    gb = torch.cat([stem_w[1], stem_w[2]]).float().detach()
    wk = _stem_weight(pk[0].detach())
    kf = cuda_ms(lambda: stem_train_fwd(x0, wk, gb, 1e-5))
    pf = cuda_ms(lambda: stem_train_reference(frames_n, *pp))
    out, yc, st_, vec = stem_train_fwd(x0, wk, gb, 1e-5)
    kb = cuda_ms(lambda: stem_train_bwd(dy, out, yc, x0, gb, st_, vec, 1e-5))
    pb = cuda_ms(lambda: grad_of(yr, pp, dy))
    lib_f, lib_b = library_stem_train(frames_n, *[p.detach() for p in pk],
                                      dy)
    lf, lb = cuda_ms(lib_f), cuda_ms(lib_b)
    entries[fwd_name]["library_ms"] = lf
    entries[bwd_name]["library_ms"] = lb
    n, hs, ws = _cells(x0)
    m_conv = n * 4 * hs * ws
    flops = 2 * m_conv * 147 * 64
    x_bytes = x0.numel() * x0.element_size()
    account(fwd_name, kf, pf, flops,
            x_bytes + 147 * 64 * 4 + out.numel() * 2 + yc.numel() * 2)
    account(bwd_name, kb, pb, flops,
            dy.numel() * 2 + out.numel() * 2 + yc.numel() * 2 + x_bytes
            + 147 * 64 * 4 + 128 * 4)
    print(f"# {'stem_' + stem + '_train':18s} "
          f"{str(tuple(x0.shape)) + (' u8' if u8 else ' bf16'):44s} "
          f"out/stats cos {w_out[2]:.6f} mean_rel {w_out[1]:.3g} | grads "
          f"cos {w_grad[2]:.6f} mean_rel {w_grad[1]:.3g} | two runs bit "
          f"for bit | fwd kernel {kf:.3f} ms plain {pf:.3f} cuDNN sequence "
          f"{lf:.3f} | bwd kernel {kb:.3f} ms plain {pb:.3f} cuDNN sequence "
          f"{lb:.3f}", flush=True)
    del out, yc
    x = y.detach()

    # --- K12: every bottleneck of the trunk, each fed the kernel output;
    # from block 1 on, K13's two links between it and the block below ---
    trunk_in = x
    below = None

    for i, (blk, kind) in enumerate(zip(blocks, kinds)):
        stride = STRIDES[kind]
        params = unpack(blk, kind)
        pk = _leaves(params)
        xk = x.detach().clone().requires_grad_()
        st = BlockTrainState(pk, stride, t, 8, 1e-5)
        st.forward(x)
        st.finale()
        dy = torch.randn(st.y.shape, generator=gen, device=dev).to(bf)
        dxk, gk = st.backward(*st.finale_backward(dy))
        pp = _leaves(params)
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
        f, co = st.f, st.co

        kf = cuda_ms(lambda: _block_fwd(x, st, t))
        kb = cuda_ms(lambda: _block_bwd(x, st, dy, t))
        if passes is not None:
            passes.append((x, st, dy))
        pf = cuda_ms(lambda: tsm_block_train_reference(
            xk, w1, w2, w3, g1, be1, g2, be2, g3, be3, t, 8, 1e-5, wp, gp,
            bep, stride))
        pb = cuda_ms(lambda: grad_of(yr, [xk] + pp, dy))
        lib_note = ""
        if library:
            lib_f, lib_b = library_block_train(x, params, stride, t, dy)
            lf, lb = cuda_ms(lib_f), cuda_ms(lib_b)
            for name, ms in (("tsm_block_train_fwd", lf),
                             ("tsm_block_train_bwd", lb)):
                entries[name]["library_ms"] = \
                    entries[name].get("library_ms", 0.0) + ms
            lib_note = f" | cuDNN sequence fwd {lf:.3f} ms bwd {lb:.3f}"
            del lib_f, lib_b
        nt, h, w, c = x.shape
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
              f"{pb:.3f}{lib_note}", flush=True)

        # the finale and its backward prologue alone (the trunk launches
        # them for its top block only)
        p, r = st.saved[2], st.residual()
        aff = [st.vec[4 * f + k * co:4 * f + (k + 1) * co] for k in range(4)]
        mus = (st.stats[4 * f:4 * f + co],
               st.stats[4 * f + 2 * co:4 * f + 3 * co])
        sap_sbp = aff[2:] if st.proj else (None, None)

        def plain_finale_bwd():
            dq = torch.where(st.y > 0, dy, torch.zeros_like(dy))
            dqf = dq.float()
            rows = [dqf.sum((0, 1, 2)),
                    (dqf * (p.float() - mus[0])).sum((0, 1, 2))]
            if st.proj:
                rows.append((dqf * (r.float() - mus[1])).sum((0, 1, 2)))
            return dq, torch.cat(rows)

        yf_r = finale_reference(p, r, aff[0], aff[1], *sap_sbp)
        dq_k, mom3_k = st.finale_backward(dy)
        dq_r, mom3_r = plain_finale_bwd()
        torch.cuda.synchronize()
        w_ff = held("tsm_trunk_train_finale_fwd", label, [(st.y, yf_r)])
        w_fb = held("tsm_trunk_train_finale_bwd", label,
                    [(dq_k, dq_r), (mom3_k[:mom3_r.numel()], mom3_r)], True)
        m_y = st.y.numel()
        account("tsm_trunk_train_finale_fwd",
                cuda_ms(lambda: finale_fwd(p, r, st.vec, f, co, st.proj)),
                cuda_ms(lambda: finale_reference(p, r, aff[0], aff[1],
                                                 *sap_sbp)),
                0, 2 * m_y * 3 + 16 * co)
        account("tsm_trunk_train_finale_bwd",
                cuda_ms(lambda: st.finale_backward(dy)),
                cuda_ms(plain_finale_bwd), 0,
                2 * m_y * (5 if st.proj else 4) + 12 * co)
        print(f"# {'finale':18s} {label:44s} fwd cos {w_ff[2]:.6f} bwd cos "
              f"{w_fb[2]:.6f} mean_rel {w_fb[1]:.3g}", flush=True)

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
        if below is not None:
            link_phase(below, st, dy, label)
        below = st
        x = st.y.detach()
        del yr, gr, p_k, p_r
    return entries, trunk_in, x


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
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_train_bwd,
        stem_train_fwd,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        BlockTrainState,
        _block,
        block_train_bwd,
        block_train_fwd,
        finale_bwd,
        finale_fwd,
        trunk_link_bwd,
        trunk_link_fwd,
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
    t = CLIP_FRAMES

    def trunk_phase(trunk_in, blocks, y_shape):
        """K13: the trunk Function against the chain of per-block
        Functions on the same kernels. The forward must agree bit for bit
        (the links compute the finales' values, and the recomputed p is
        the forward's), the gradients in the bands (the backward moments
        sum in another order), two runs of the trunk bit for bit, and the
        trunk must keep less on the card after its forward: no p."""
        tparams = [blk.train_params() for blk in blocks]
        kinds = [blk.kind() for blk in blocks]
        dy = torch.randn(y_shape, generator=gen, device=dev).to(bf)
        n_fwd = 1 + sum(6 if k == "plain" else 8 for k in kinds)

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

        def trunk(x_in, ps):
            return tsm_trunk_train(x_in, ps, kinds, t)

        counters = (recompute_p, trunk_link_fwd, trunk_link_bwd, finale_fwd,
                    finale_bwd, block_train_fwd, block_train_bwd)
        for fn in counters:
            fn.launches = 0
        kept_t, out_t = run(trunk, [_leaves(p) for p in tparams])
        torch.cuda.synchronize()
        one_step = {fn.__name__: fn.launches for fn in counters}
        kept_c, out_c = run(chain, [_leaves(unpack(p, k))
                                    for p, k in zip(tparams, kinds)])
        _, out_t2 = run(trunk, [_leaves(p) for p in tparams])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out_t[:n_fwd],
                                                     out_c[:n_fwd])):
            fail("tsm_trunk_train's forward differs from the chain's")
        # leaves: x, then each block's parameters in order; the top
        # block's gradients come before any link, the others after one
        # link or more, whose moment order batch-stat BN amplifies
        rels = [compare(a, b) for a, b in zip(out_t[n_fwd:], out_c[n_fwd:])]
        worst = (max(r[0] for r in rels), max(r[1] for r in rels),
                 min(r[2] for r in rels))
        worst_leaf = max(range(len(rels)), key=lambda i: rels[i][1])
        n_top = 9 if kinds[-1] == "plain" else 12
        top_rel = max(r[1] for r in rels[-n_top:])
        if not (worst[2] >= GRAD_MIN_COS and worst[1] <= GRAD_MAX_MEAN_REL):
            fail(f"tsm_trunk_train's gradients leave the band around the "
                 f"chain's: {worst}")
        if not all(torch.equal(a, b) for a, b in zip(out_t, out_t2)):
            fail("two runs of tsm_trunk_train differ")
        del out_t, out_c, out_t2
        dparams = [[q.detach() for q in p] for p in tparams]
        dparams12 = [unpack(p, k) for p, k in zip(dparams, kinds)]
        _, states = trunk_train_fwd(trunk_in, dparams, kinds, t, 8, 1e-5)
        p_bytes = sum(st.saved[1].numel() // st.f * st.co * 2
                      for st in states)
        # the caching allocator may hand a tensor a cached block up to 1
        # MiB larger than it asked for
        if kept_c - kept_t < p_bytes - len(states) * 2 ** 20:
            fail(f"the trunk keeps {kept_t} bytes after its forward, the "
                 f"chain {kept_c}: fewer than the {p_bytes} bytes of p saved")

        def chain_fwd():
            out, x_in = [], trunk_in
            for p12, kind in zip(dparams12, kinds):
                st = BlockTrainState(p12, STRIDES[kind], t, 8, 1e-5)
                st.forward(x_in)
                x_in = st.finale()
                out.append(st)
            return out

        def chain_bwd(chain_states):
            g = dy
            for st in reversed(chain_states):
                g, _ = st.backward(*st.finale_backward(g))

        kf = cuda_ms(lambda: trunk_train_fwd(trunk_in, dparams, kinds, t, 8,
                                             1e-5))
        kb = cuda_ms(lambda: trunk_train_bwd(dy, list(states)))
        chain_states = chain_fwd()
        cf, cb = cuda_ms(chain_fwd), cuda_ms(lambda: chain_bwd(chain_states))
        # bounds: the trunk Function's inputs read once and outputs written
        # once: forward x and the weights (float32) in, the residuals it
        # keeps (each block's input past the first, u, z, pr) and y out;
        # backward dy, those residuals and the weights in, dx and the
        # float32 weight gradients out; the backward's products twice the
        # forward's, plus the recomputed p
        f_flops = f_bytes = b_flops = b_bytes = 0
        for i, st in enumerate(states):
            nt, h, w, c = st.x.shape
            fl, m_in, m_out, nw = block_work(nt, h, w, c, st.f, st.co,
                                             st.stride, st.proj)
            kept = 2 * (m_in * st.f + m_out * st.f
                        + (m_out * st.co if st.proj else 0)
                        + (m_in * c if i else 0))
            f_flops += fl
            b_flops += 2 * fl + 2 * m_out * st.f * st.co
            f_bytes += 4 * nw + kept
            b_bytes += 8 * nw + kept
        f_bytes += 2 * (trunk_in.numel() + dy.numel())
        b_bytes += 2 * (trunk_in.numel() + 2 * dy.numel())
        bf_ms, bf_by = bound(f_flops, f_bytes)
        bb_ms, bb_by = bound(b_flops, b_bytes)
        del states, chain_states
        torch.cuda.empty_cache()
        print(f"# {'tsm_trunk_train':18s} {str(tuple(trunk_in.shape)):44s} "
              f"vs block chain: forward bitwise True, gradients worst cos "
              f"{worst[2]:.6f} mean_rel {worst[1]:.3g} (leaf {worst_leaf} of "
              f"{len(rels)}; the top block's worst mean_rel {top_rel:.3g}), "
              f"two runs bitwise "
              f"True; kept after the forward {kept_t} bytes vs {kept_c} "
              f"({kept_c - kept_t} less, p is {p_bytes}); launches per "
              f"forward+backward {one_step} | trunk fwd {kf:.3f} ms bwd "
              f"{kb:.3f} ms, chain fwd {cf:.3f} ms bwd {cb:.3f} ms, bound "
              f"fwd {bf_ms:.3f} ms ({bf_by}) bwd {bb_ms:.3f} ms ({bb_by}) "
              f"on {smi}", flush=True)

    def remat_phase(x0, trunk_peak, argv, paths):
        """model.remat_vision: one full-width training step of the vision
        trunk with each block on its K12 Function under a checkpoint, bit
        for bit the same chain of Functions without one; peak memory of
        the two and of the fused trunk; then train_segment with
        model.remat_vision=true for 2 steps of TRAIN_CLIPS clips."""
        counters = (stem_train_fwd, stem_train_bwd, block_train_fwd,
                    block_train_bwd, finale_fwd, finale_bwd, trunk_link_fwd,
                    trunk_link_bwd, recompute_p)
        params = list(vision.parameters())
        saved_buffers = [b.detach().clone() for b in vision.buffers()]
        cot = {}

        def step(remat, impl):
            vision.remat, vision.tsm_impl = remat, impl
            vision.train()
            try:
                out = vision.forward_train(x0)
                if "dy" not in cot:
                    cot["dy"] = torch.randn(out.shape, generator=gen,
                                            device=dev).to(out.dtype)
                return [out] + list(torch.autograd.grad(out, params,
                                                        cot["dy"]))
            finally:
                vision.remat, vision.tsm_impl = False, "auto"
                vision.eval()
                with torch.no_grad():
                    for b, v in zip(vision.buffers(), saved_buffers):
                        b.copy_(v)

        modes = {"remat": (True, "auto"),
                 "chain": (False, ("fusedtrain",) * 4),
                 "trunk": (False, "auto")}
        got, peaks, ms, counts = {}, {}, {}, {}
        for name, mode in modes.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            for fn in counters:
                fn.launches = 0
            out = step(*mode)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated(dev) - base
            counts[name] = {fn.__name__: fn.launches for fn in counters
                            if fn.launches}
            if name != "trunk":
                got[name] = out
            del out
            ms[name] = cuda_ms(lambda mode=mode: step(*mode))
        if not all(torch.equal(a, b) for a, b in zip(got["remat"],
                                                     got["chain"])):
            fail("the remat vision step differs from the chain of per-block "
                 "Functions")
        n = len(vision.blocks())
        want = {"stem_train_fwd": 1, "stem_train_bwd": 1,
                "block_train_fwd": 2 * n, "finale_fwd": 2 * n,
                "block_train_bwd": n, "finale_bwd": n}
        if counts["remat"] != want:
            fail(f"remat vision step launches {counts['remat']} != {want}")
        del got
        torch.cuda.empty_cache()
        print(f"# remat vision step ({tuple(x0.shape)} u8, stem to pooled "
              f"features, forward+backward): outputs and gradients bitwise "
              f"the per-block chain's; launches {counts['remat']}; peak "
              f"device memory above the start: remat {peaks['remat']} bytes, "
              f"chain {peaks['chain']}, fused trunk {peaks['trunk']}; step "
              f"ms: remat {ms['remat']:.3f}, chain {ms['chain']:.3f}, fused "
              f"trunk {ms['trunk']:.3f} on {smi}", flush=True)

        # train_segment with model.remat_vision=true: 2 steps
        vids = open(paths["train_vid_file"]).read().split()
        remat_vids = build / "remat_train_vids.txt"
        remat_vids.write_text("\n".join(vids[:2 * TRAIN_CLIPS]) + "\n")
        rargv = [a for a in argv if not a.startswith(
            ("data.train_vid_file=", "train.ckpt_dir=", "train.log_dir="))]
        rargv += [f"data.train_vid_file={remat_vids}",
                  "model.remat_vision=true",
                  f"train.ckpt_dir={build / 'remat_ckpt'}",
                  f"train.log_dir={build / 'remat_logs'}"]
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters:
            fn.launches = 0
        t0 = time.time()
        trainer = train_segment.main(rargv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        steps = trainer.step
        launches = {fn.__name__: fn.launches for fn in counters
                    if fn.launches}
        want = {k: v * steps for k, v in want.items()}
        logs = [json.loads(line) for line in
                open(build / "remat_logs" / "scalars.jsonl")]
        loss = [r["value"] for r in logs if r["tag"] == "train/loss"][-1]
        step_s = trainer.timer.summary()["train_step"]["seconds"] / steps
        print(f"# train_segment model.remat_vision=true: {steps} steps of "
              f"{TRAIN_CLIPS} clips in {wall:.1f} s, {step_s * 1e3:.1f} ms a "
              f"step (first-step build included), peak device memory "
              f"{peak} bytes (without remat {trunk_peak}), loss {loss:.4f}, "
              f"launches {launches} on {smi}", flush=True)
        if steps != 2 or not math.isfinite(loss) or launches != want:
            fail(f"train_segment with remat: {steps} steps, loss {loss}, "
                 f"launches {launches} != {want}")
        del trainer
        torch.cuda.empty_cache()

    # K11, then each bottleneck fed the kernel output, its finale, its p
    # made again and, from block 1 on, K13's two links to the block below
    blocks = vision.blocks()
    passes = []  # (x, state, dy) of each block, for k12_split
    entries, trunk_in, x = hold_train_kernels(
        dev, gen, x0, [vision.conv1.weight.permute(2, 3, 1, 0),
                       vision.bn1.weight, vision.bn1.bias],
        [blk.train_params() for blk in blocks],
        [blk.kind() for blk in blocks], t, passes, library=True)

    def k12_split():
        """K12's device time a step by what its kernels compute, from one
        torch.profiler trace of each direction over one call of every
        block: the forward GEMM of each conv (conv1, proj, conv2, conv3 in
        launch order), dgrad, wgrad, the BN-vector and reduction kernels,
        the finale; information only."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        def kind(name):
            for key in ("finale", "wgrad", "dgrad", "conv_fwd"):
                if key in name:
                    return key
            return ("bn/reduce" if "reduce" in name or "bn_" in name
                    else "other")

        parts = []
        for direction in ("fwd", "bwd"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for xb, st, dyb in passes:
                    if direction == "fwd":
                        _block_fwd(xb, st, t)
                    else:
                        _block_bwd(xb, st, dyb, t)
                torch.cuda.synchronize()
            kern = sorted((e for e in prof.events()
                           if e.device_type == DeviceType.CUDA),
                          key=lambda e: e.time_range.start)
            # the forward of each block ends with its finale: within its
            # run of kernels the GEMMs are conv1, [proj,] conv2, conv3
            names = {}
            if direction == "fwd":
                segs, cur = [], []
                for e in kern:
                    cur.append(e)
                    if kind(e.name) == "finale":
                        segs.append(cur)
                        cur = []
                for seg, (_, st, _) in zip(segs, passes):
                    gemms = [e for e in seg if kind(e.name) == "conv_fwd"]
                    labels = (("conv1", "proj", "conv2", "conv3") if st.proj
                              else ("conv1", "conv2", "conv3"))
                    for e, c in zip(gemms[len(gemms) - len(labels):], labels):
                        names[id(e)] = c
            split = {}
            for e in kern:
                k = names.get(id(e), kind(e.name))
                if k == "conv_fwd":
                    k = "conv ?"
                split[k] = split.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
            if not split:
                return "not measured: the profiler saw no device time"
            split["total"] = sum(split.values())
            parts.append(f"{direction} " + ", ".join(
                f"{k} {v:.3f}" for k, v in split.items()))
        return "; ".join(parts)
    try:
        split = k12_split()
    except Exception as exc:  # the split is information only
        split = f"not measured ({type(exc).__name__}: {exc})"
    print(f"# K12 device ms a step by kernel ({len(passes)} blocks, one "
          f"traced call each): {split} on {smi}", flush=True)
    del passes
    torch.cuda.empty_cache()
    trunk_phase(trunk_in, blocks, x.shape)

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
               "tsm_trunk_train_finale_fwd": finale_fwd,
               "tsm_trunk_train_finale_bwd": finale_bwd,
               "tsm_trunk_train_link_fwd": trunk_link_fwd,
               "tsm_trunk_train_link_bwd": trunk_link_bwd,
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
    # per step: the top block's finale and its backward prologue only, a
    # link between each two blocks, p made again once per block
    per_step = {"stem_s2d_train_fwd": 1, "stem_s2d_train_bwd": 1,
                "tsm_block_train_fwd": len(blocks),
                "tsm_block_train_bwd": len(blocks),
                "tsm_trunk_train_finale_fwd": 1,
                "tsm_trunk_train_finale_bwd": 1,
                "tsm_trunk_train_link_fwd": len(blocks) - 1,
                "tsm_trunk_train_link_bwd": len(blocks) - 1,
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
    remat_phase(x0, peak, argv, paths)

    return train_kernel_rows(entries, launches)


def title_decode_phase(dev, smi, s2s):
    """Greedy title decode of Pegasus-large in bf16 and with --int8_titles'
    weight-only int8 + int8 cross cache, same weights, same batch and
    inputs: ms per step (CUDA events) and, from one torch.profiler trace
    of each, kernels per step, device-busy share and the share of device
    time in copy (dtype cast) kernels."""
    import dataclasses

    import torch

    from video_chapter_generation_tpu_torch.models.seq2seq import (
        Seq2Seq,
        generate,
    )
    from video_chapter_generation_tpu_torch.ops.quantize import (
        quantize_seq2seq,
    )

    cfg = s2s.cfg
    qcfg = dataclasses.replace(cfg, weight_quant=True, kv_quant=True)
    with torch.device("meta"):
        s2s_q = Seq2Seq(qcfg)
    s2s_q.load_state_dict(quantize_seq2seq(s2s.state_dict()), assign=True)
    s2s_q.to(dev, torch.bfloat16).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    ids = torch.randint(2, cfg.vocab_size, (TITLE_BUCKET, TITLE_IN),
                        generator=gen, device=dev)
    mask = torch.ones_like(ids)
    for name, m in (("bf16", s2s), ("int8", s2s_q)):
        run = lambda m=m: generate(m, ids, mask, max_len=TITLE_OUT)  # noqa: E731
        out = run()
        if tuple(out.shape) != (TITLE_BUCKET, TITLE_OUT) or \
                int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
            fail(f"{name} title decode gave ids of shape {tuple(out.shape)}")
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[2]
        trace = "trace: not measured"
        try:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            t0 = time.time()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            wall_us = (time.time() - t0) * 1e6
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]

            def dev_us(e):
                return (getattr(e, "self_device_time_total", 0)
                        or getattr(e, "self_cuda_time_total", 0))

            busy = sum(dev_us(e) for e in kern)
            copy = sum(dev_us(e) for e in kern if "copy" in e.key.lower())
            count = sum(e.count for e in kern)
            if busy > 0:
                trace = (f"trace: {count / TITLE_OUT:.0f} kernels per step, "
                         f"device busy {busy / wall_us:.3f} of the traced "
                         f"wall time, copy kernels {copy / busy:.3f} of the "
                         f"device time")
            else:
                trace = "trace: the profiler saw no device time"
        except Exception as exc:  # the trace is information only
            trace = f"trace: not measured ({type(exc).__name__})"
        print(f"# title decode {name}, batch {TITLE_BUCKET}, encoder "
              f"{TITLE_IN}, {TITLE_OUT} greedy steps: {ms / TITLE_OUT:.3f} ms "
              f"per step (encoder included, median of 5); {trace}; on {smi}",
              flush=True)
    del s2s_q
    torch.cuda.empty_cache()


def infer_phases(dev, smi, frames, vision, ts_sd, delta):
    """K8 and K9 against their plain versions at the shapes of one
    256-frame vision call, then cli/infer_video end to end. Returns the
    kernels' JSON entries, the CLI's argv and its run (each video's cut
    points and titles, the launch counts, the vision calls)."""
    import os

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import infer_video
    from video_chapter_generation_tpu_torch.cli.common import (
        load_bert_tokenizer,
        load_corpus,
        parse_config,
    )
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.core.contract import vocab_hash
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.models.resnet import ResNet
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.quantize import (
        calibrate_resnet_quant,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        _conv7,
        bn_relu_maxpool,
        bn_relu_maxpool_reference,
        stem_frames,
        stem_frames_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        int8_bottleneck,
        int8_bottleneck_plain,
        tsm_bottleneck_int8,
    )
    from video_chapter_generation_tpu_torch.train.tasks import SegmentTask

    bf = torch.bfloat16
    entries = {k: {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0,
                   "max_abs": 0.0}
               for k in ("stem_frames", "bn_relu_maxpool",
                         "tsm_bottleneck_int8")}

    def held(name, label, kernel, plain, flops, nbytes, exact_int=False,
             exact=False, library=None):
        return hold(entries, name, label, kernel, plain, flops, nbytes,
                    exact_int, exact, library=library)

    # the frames-stem trunk on the serving trunk's weights (shared storage)
    with torch.device("meta"):
        vf = ResNet(50, n_segment=CLIP_FRAMES, stem_input="frames", dtype=bf)
    vf.load_state_dict(vision.state_dict(), assign=True)
    vf.eval()
    stem_p, block_ps = vf.folded_params()
    x_in = normalize_frames(depth_to_space4(frames), bf).contiguous()
    n, hh = x_in.shape[0], x_in.shape[1]

    # --- K8: the frames stem (one launch, the pool fused), and the pool
    # kernel that K14b still launches, at its former shape ---
    args = (stem_p["w7"], stem_p["s"], stem_p["b"])
    m_conv = n * (hh // 2) ** 2
    y = held("stem_frames", f"{tuple(x_in.shape)} bf16",
             lambda: stem_frames(x_in, *args),
             lambda: stem_frames_reference(x_in, *args),
             2 * m_conv * 147 * 64,
             x_in.numel() * 2 + 147 * 64 * 2 + n * (hh // 4) ** 2 * 64 * 2,
             library=library_stem(x_in, *args))
    conv = _conv7(x_in, stem_p["w7"]).contiguous()
    held("bn_relu_maxpool", f"{tuple(conv.shape)} bf16",
         lambda: bn_relu_maxpool(conv, stem_p["s"], stem_p["b"]),
         lambda: bn_relu_maxpool_reference(conv, stem_p["s"], stem_p["b"]),
         2 * conv.numel(), conv.numel() * 2 + conv.numel() // 2 + 64 * 8,
         exact=True, library=library_pool(conv, stem_p["s"], stem_p["b"]))
    del conv

    # --- K9: calibrate on the card, then each W8A8 block vs its plain ---
    t0 = time.time()
    scales = calibrate_resnet_quant(vf, x_in)
    torch.cuda.synchronize()
    print(f"# calibrated {len(scales)} blocks on {n} frames in "
          f"{time.time() - t0:.2f} s", flush=True)
    vq = vf.quantized(scales)
    plan, qps = vq._quant_plan(None), vq.quant_params()
    layer_of = [k + 1 for k, nb in enumerate(vf.stage_sizes)
                for _ in range(nb)]
    yb, bf16_ms, split_runs = y, 0.0, []  # the bf16 chain beside
    for i, (blk, p) in enumerate(zip(vf.blocks(), block_ps)):
        mode = plan[i]
        if mode is None:
            y = blk.run(y, p, CLIP_FRAMES, 8)
            yb = y
            continue
        # the yardstick: the bf16 K2/K3 launch of the same block (its float
        # weights before quantization) on the bf16 chain's input
        bf16_ms += cuda_ms(lambda yb=yb, blk=blk, p=p: blk.run(
            yb, p, CLIP_FRAMES, 8))
        yb = blk.run(yb, p, CLIP_FRAMES, 8)
        q = qps[i]
        nt, h, w, c = y.shape
        f = q.f
        m = nt * h * w
        label = (f"block {i:2d} {tuple(y.shape)} {str(y.dtype)[6:]} -> "
                 f"{mode} F={f}")
        xb, nbytes = y, (y.numel() * y.element_size()
                         + 2 * c * f + 9 * f * f + m * c * (1 if mode == "i8"
                                                            else 2))
        kernel = (lambda xb=xb, q=q, mode=mode: int8_bottleneck(
            xb, q, CLIP_FRAMES, 8, mode, bf))
        y = held("tsm_bottleneck_int8", label, kernel,
                 lambda xb=xb, q=q, mode=mode: int8_bottleneck_plain(
                     xb, q, CLIP_FRAMES, 8)[1 if mode == "i8" else 0].to(
                         torch.int8 if mode == "i8" else bf),
                 2 * m * (2 * c * f + 9 * f * f), nbytes,
                 exact_int=mode == "i8")
        split_runs.append((f"layer{layer_of[i]}", False, kernel))
    n_int8 = sum(1 for mode in plan if mode)
    try:
        split = serving_split(split_runs, by_name=True)
    except Exception as exc:  # the split is information only
        split = f"not measured ({type(exc).__name__}: {exc})"
    k9_ms = entries["tsm_bottleneck_int8"]["ms"]
    print(f"# K9 on {n_int8} W8A8 blocks: {k9_ms:.3f} ms; the bf16 K2/K3 "
          f"launches of the same blocks {bf16_ms:.3f} ms; "
          f"K9 device ms by conv and layer (one traced call each): {split} "
          f"on {smi}", flush=True)
    del split_runs, yb
    if n_int8 != 10:
        fail(f"{n_int8} W8A8 blocks planned, not 10")
    clip = x_in[:CLIP_FRAMES]
    f_bf16, f_int8 = vf(clip).float(), vq(clip).float()
    f_unit = vf.quantized({})(clip).float()
    cos = torch.nn.functional.cosine_similarity(f_int8, f_bf16, dim=1)
    unit_gap = (f_unit - f_int8).abs().max().item()
    print(f"# W8A8 trunk vs bf16 kernel trunk, one clip: per-frame cosine "
          f"min {cos.min().item():.6f}; unit scales move the features by "
          f"up to {unit_gap:.4g}", flush=True)
    if cos.min().item() < INT8_TRUNK_MIN_COS:
        fail("the W8A8 trunk disagrees with the bf16 trunk")
    if torch.allclose(f_unit, f_int8, rtol=1e-2, atol=1e-2):
        fail("unit scales give the calibrated trunk's answer")
    del x_in, clip, y

    # --- cli/infer_video end to end, from a checkpoint ---
    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    paths = make_synth_corpus_on_disk(
        str(build / "synth_infer_corpus"), n_videos=INFER_VIDEOS,
        video_sec=INFER_SEC, seed=SEED + 5)
    ckpt_dir = build / "infer_ckpt"
    argv = [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.test_vid_file={paths['vid_file']}",
            "model.kind=two_stream", "model.stem_input=frames",
            f"data.clip_frame_num={CLIP_FRAMES}",
            f"data.batch_size={SCORE_BATCH}", f"train.ckpt_dir={ckpt_dir}"]
    cfg, args = parse_config(argv)
    corpus = load_corpus(cfg, "test")
    contract = dict(SegmentTask(cfg).contract, vocab_hash=vocab_hash(
        load_bert_tokenizer(args, corpus)))
    sd = dict(ts_sd)
    bias = sd["fusion_head.head.bias"].clone()
    bias[1] += delta
    sd["fusion_head.head.bias"] = bias
    for old in ckpt_dir.glob("ckpt_*"):
        old.unlink()
    CheckpointManager(str(ckpt_dir)).save(
        0, {"model": sd, "optimizer": {}, "step": 0},
        metrics={"best_result": float("-inf"), "contract": contract})
    counted = (normalize_frames, stem_frames, bn_relu_maxpool,
               tsm_bottleneck, tsm_bottleneck_s2, tsm_bottleneck_int8)
    for fn in counted:
        fn.launches = 0
    cwd = os.getcwd()
    os.chdir(build)  # the CLI writes test_results/ where it runs
    said = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(said):
            results = infer_video.main(argv + ["--int8_vision",
                                               "--int8_titles", "--pipelined"])
    finally:
        os.chdir(cwd)
        for line in said.getvalue().splitlines():
            print(f"# cli: {line}", flush=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if "restored checkpoint at epoch 0" not in said.getvalue():
        fail("infer_video did not restore the checkpoint")
    launches = {fn.__name__: fn.launches for fn in counted}
    calls = sum(math.ceil(len(r.clip_scores) / SCORE_BATCH)
                for r in results.values())
    # the frames stem fuses its pool: no bn_relu_maxpool launch
    per_call = {"normalize_frames": 1, "stem_frames": 1,
                "bn_relu_maxpool": 0, "tsm_bottleneck": 3,
                "tsm_bottleneck_s2": 3, "tsm_bottleneck_int8": 10}
    calib = {"normalize_frames": 1, "stem_frames": 1, "bn_relu_maxpool": 0,
             "tsm_bottleneck": 13, "tsm_bottleneck_s2": 3,
             "tsm_bottleneck_int8": 0}
    want = {k: v * calls + calib[k] for k, v in per_call.items()}
    run = {"results": {vid: (r.cut_points, r.titles)
                       for vid, r in results.items()},
           "launches": launches, "calls": calls}
    print(f"# infer_video --int8_vision --int8_titles --pipelined: "
          f"{len(results)} videos, {calls} vision calls (+1 calibration "
          f"call), launches {launches}, {wall:.1f} s (models, calibration "
          f"and checkpoint restore included) on {smi}", flush=True)
    if launches != want:
        fail(f"infer_video launch counts {launches} != {want}")
    for vid, r in results.items():
        scores = np.asarray(r.clip_scores, np.float64)
        print(f"# {vid}: {len(scores)} clips, cut points {r.cut_points}, "
              f"{len(r.titles)} titles, first {r.titles[:1]!r}", flush=True)
        if not (np.isfinite(scores).all() and (scores >= 0).all()
                and (scores <= 1).all()):
            fail(f"{vid}: clip scores outside [0, 1]")
        if not r.cut_points or len(r.titles) != len(r.spans):
            fail(f"{vid}: {len(r.cut_points)} cut points, "
                 f"{len(r.titles)} titles for {len(r.spans)} chapters")
    if len(results) != INFER_VIDEOS:
        fail(f"infer_video chaptered {len(results)} videos")
    # one unbucketed greedy generate per video with chapters
    stages = json.loads(said.getvalue().split("stage seconds: ")[1]
                        .splitlines()[0])
    steps = sum(1 for r in results.values() if r.spans) * TITLE_OUT
    print(f"# int8 title decode (weight-only int8 Pegasus-large, int8 cross "
          f"cache, batch = one video's chapters): "
          f"{1e3 * stages['title_generate']['seconds'] / steps:.2f} ms per "
          f"greedy step over {steps} steps on {smi}", flush=True)
    torch.cuda.empty_cache()

    sources = {"stem_frames": ("csrc/stem_s2d.cu", "stem_pallas.py:255"),
               "bn_relu_maxpool": ("csrc/stem_s2d.cu", "stem_pallas.py:71"),
               "tsm_bottleneck_int8": ("csrc/tsm_bottleneck_int8.cu",
                                       "tsm_block_int8_pallas.py:437")}
    out = []
    for name, e in entries.items():
        src, replaces = sources[name]
        peak = PEAK_INT8_OPS if name == "tsm_bottleneck_int8" else \
            PEAK_BF16_FLOPS
        b_ms, b_by = bound(e["flops"], e["bytes"], peak)
        out.append({"name": name, "route": "cuda",
                    "source": f"video_chapter_generation_tpu_torch/{src}",
                    "replaces": f"video_chapter_generation_tpu/ops/{replaces}",
                    "launches": launches[name], "max_abs_err": e["max_abs"],
                    "ms": e["ms"], "plain_ms": e["plain_ms"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    # the stem's cuDNN sequence, the pool's torch ops and
                    # F.max_pool2d; no one PyTorch call computes the W8A8
                    # block
                    "library_ms": e.get("library_ms")})
    return out, argv, run


def hold_k10(q_mid, k, v, mask, tabs, bs, name, label, smi):
    """K10 (sparse_band_attention) on these inputs against its plain
    version, in the bf16 bands, then a second run bit for bit (no float
    atomics); times the kernel, the plain version and the SDPA yardstick.
    Returns the kernels-line numbers of these inputs (max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms)."""
    import torch

    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
        sparse_band_attention_reference,
    )

    b, l, h, hd = k.shape
    out = torch.empty_like(k)
    run = lambda: sparse_band_attention(  # noqa: E731
        q_mid, k, v, mask, *tabs, bs, out)
    plain = lambda: sparse_band_attention_reference(  # noqa: E731
        q_mid, k, v, mask, *tabs, bs)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    max_abs, mean_rel, cos = compare(got, ref)
    library, _ = sdpa_yardstick(q_mid, k, v, mask, tabs, bs)
    lib_cos = compare(library().transpose(1, 2), ref)[2]
    k_ms, p_ms, lib_ms = cuda_ms(run), cuda_ms(plain), cuda_ms(library)
    nbq, n_parts = tabs[0].shape
    b_ms, b_by = bound(4 * b * h * nbq * bs * (n_parts * bs) * hd,
                       2 * (2 * q_mid.numel() + k.numel() + v.numel())
                       + 4 * mask.numel())
    print(f"# {name:18s} q_mid {tuple(q_mid.shape)} k/v {tuple(k.shape)} "
          f"bs {bs} P {n_parts} bf16, {label}: max_abs {max_abs:.4g} "
          f"mean_rel {mean_rel:.3g} cos {cos:.6f} | kernel {k_ms:.3f} ms "
          f"plain {p_ms:.3f} ms library (SDPA, float mask) {lib_ms:.3f} ms "
          f"(its cos vs plain {lib_cos:.6f}) bound {b_ms:.3f} ms ({b_by}) "
          f"on {smi}", flush=True)
    if not (cos >= KERNEL_MIN_COS and mean_rel <= KERNEL_MAX_MEAN_REL):
        fail(f"{name} ({label}) disagrees with its plain version")
    first = got.clone()
    if not torch.equal(first, run()):
        fail(f"two runs of {name} ({label}) differ")
    print(f"# {name:18s} two runs bit for bit", flush=True)
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


@contextlib.contextmanager
def first_calls(spots):
    """While open, module.name for each (module, name) -> n of spots keeps
    the arguments of its first n calls (tensors cloned, in lists and
    tuples too) in kept[name], a list of (args, kwargs); yields kept. The
    call itself goes on to the function, whose launch count is the one
    that counts."""
    import torch

    def keep(a):
        if type(a) in (list, tuple):
            return type(a)(map(keep, a))
        return a.clone() if torch.is_tensor(a) else a

    kept = {name: [] for _, name in spots}
    real = {spot: getattr(*spot) for spot in spots}
    for (mod, name), n in spots.items():
        def spy(*args, _fn=real[(mod, name)], _calls=kept[name], _n=n,
                **kwargs):
            if len(_calls) < _n:
                _calls.append((tuple(map(keep, args)),
                               {k: keep(v) for k, v in kwargs.items()}))
            return _fn(*args, **kwargs)

        setattr(mod, name, spy)
    try:
        yield kept
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def hold_vision_call(kept):
    """The kernels of one vision call, each on the arguments that
    first_calls kept from the path's own launches (normalize_frames,
    stem_frames, tsm_bottleneck, tsm_bottleneck_s2, int8_bottleneck: those
    kept), against its plain version, timed beside it and its yardstick.
    Returns {kernel name: its kernels-line numbers}, per vision call: times
    and work summed over the call's launches, the bound the sum of each
    launch's (K9's operations at the int8 peak)."""
    import torch

    from video_chapter_generation_tpu_torch.ops.preprocess import (
        affine_consts,
        normalize_frames,
        normalize_frames_reference,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        stem_frames,
        stem_frames_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_reference,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        int8_bottleneck,
        int8_bottleneck_plain,
    )

    entries, parts = {}, {}

    def held(name, label, kernel, plain, flops, nbytes, **kw):
        entries.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0,
                                  "bytes": 0.0, "max_abs": 0.0})
        parts.setdefault(name, []).append((flops, nbytes))
        return hold(entries, name, label, kernel, plain, flops, nbytes, **kw)

    for (u8, dt), _ in kept.get("normalize_frames", []):
        held("normalize_frames", f"{tuple(u8.shape)} u8 -> {str(dt)[6:]}",
             lambda: normalize_frames(u8, dt),
             lambda: normalize_frames_reference(u8, dt), 2 * u8.numel(),
             u8.numel() * (1 + torch.empty((), dtype=dt).element_size()),
             exact=True)
        # the yardstick: one torch.addcmul of the same affine (float32 out)
        scale, bias = affine_consts(u8.device)
        entries["normalize_frames"]["library_ms"] = cuda_ms(
            lambda: torch.addcmul(bias, u8, scale))
    for (x, w7, s, b), _ in kept.get("stem_frames", []):
        n, hh = x.shape[0], x.shape[1]
        held("stem_frames", f"{tuple(x.shape)} {str(x.dtype)[6:]}",
             lambda: stem_frames(x, w7, s, b),
             lambda: stem_frames_reference(x, w7, s, b),
             2 * n * (hh // 2) ** 2 * 147 * 64,
             x.numel() * 2 + 147 * 64 * 2 + n * (hh // 4) ** 2 * 64 * 2,
             library=library_stem(x, w7, s, b))
    for name, stride in (("tsm_bottleneck", 1), ("tsm_bottleneck_s2", 2)):
        for i, (args, _) in enumerate(kept.get(name, [])):
            x, ws = args[0], args[1:10]
            if stride == 1:
                n_seg, n_div, wp, sp, bp = args[10:15]
                kernel = (lambda args=args: tsm_bottleneck(*args))
            else:
                wp, sp, bp, n_seg, n_div = args[10:15]
                kernel = (lambda args=args: tsm_bottleneck_s2(*args))
            nt, h, w, c = x.shape
            f, co = ws[0].shape[1], ws[2].shape[1]
            flops, _, m_out, nw = block_work(nt, h, w, c, f, co, stride,
                                             wp is not None)
            held(name, f"launch {i:2d} {tuple(x.shape)} F={f}"
                 + (" proj" if wp is not None else ""), kernel,
                 lambda x=x, ws=ws, n_seg=n_seg, n_div=n_div, wp=wp, sp=sp,
                 bp=bp, stride=stride: tsm_bottleneck_reference(
                     x, *ws, n_seg, n_div, wp, sp, bp, stride=stride),
                 flops, x.numel() * 2 + nw * 2 + m_out * co * 2,
                 library=library_block(x, *ws, wp, sp, bp, stride, n_seg))
    for i, ((x, q, n_seg, n_div, mode, dt), _) in enumerate(
            kept.get("int8_bottleneck", [])):
        nt, h, w, c = x.shape
        f, m = q.f, nt * h * w
        held("tsm_bottleneck_int8",
             f"launch {i:2d} {tuple(x.shape)} {str(x.dtype)[6:]} -> {mode} "
             f"F={f}",
             lambda x=x, q=q, n_seg=n_seg, n_div=n_div, mode=mode, dt=dt:
                 int8_bottleneck(x, q, n_seg, n_div, mode, dt),
             lambda x=x, q=q, n_seg=n_seg, n_div=n_div, mode=mode, dt=dt:
                 int8_bottleneck_plain(x, q, n_seg, n_div)[
                     1 if mode == "i8" else 0].to(
                         torch.int8 if mode == "i8" else dt),
             2 * m * (2 * c * f + 9 * f * f),
             x.numel() * x.element_size() + 2 * c * f + 9 * f * f
             + m * c * (1 if mode == "i8" else 2), exact_int=mode == "i8")
    rows = {}
    for name, e in entries.items():
        b_ms, b_by = bound_sum(parts[name], PEAK_INT8_OPS if name ==
                               "tsm_bottleneck_int8" else PEAK_BF16_FLOPS)
        rows[name] = {"max_abs_err": e["max_abs"], "ms": e["ms"],
                      "plain_ms": e["plain_ms"], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": e.get("library_ms")}
    return rows


def resnet_to_hf(sd):
    """A port ResNet state dict (torchvision's keys) under HF ResNetModel's
    keys, the same tensors: what models/convert_hf.py:convert_hf_resnet
    reads (conv1 / bn1 -> embedder.embedder.{convolution,normalization};
    layer{s}.{b}.conv{i} / bn{i} -> encoder.stages.{s-1}.layers.{b}.layer.
    {i-1}; downsample.0 / .1 -> .shortcut)."""
    out = {}
    for key, v in sd.items():
        parts = key.split(".")
        if parts[0] in ("conv1", "bn1"):
            base, mod = "embedder.embedder", parts[0]
        else:
            base = (f"encoder.stages.{int(parts[0][5:]) - 1}.layers."
                    f"{parts[1]}")
            if parts[2] == "downsample":
                base, mod = (f"{base}.shortcut",
                             "conv" if parts[3] == "0" else "bn")
            else:
                base, mod = f"{base}.layer.{int(parts[2][-1]) - 1}", parts[2]
        kind = "convolution" if mod.startswith("conv") else "normalization"
        out[f"{base}.{kind}.{parts[-1]}"] = v
    return out


def bigbird_to_hf(sd):
    """A port BigBird-Pegasus Seq2Seq state dict under HF
    BigBirdPegasusForConditionalGeneration's keys, the same tensors: the
    encoder self-attention's {q,k,v,out}_proj as self.{query,key,value}
    and output, each side's final LayerNorm as layernorm_embedding, and
    HF's tied copies of the shared table (lm_head, embed_tokens), which
    models/convert_hf.py:convert_hf_seq2seq leaves."""
    names = {"q_proj": "self.query", "k_proj": "self.key",
             "v_proj": "self.value", "out_proj": "output"}
    out = {}
    for key, v in sd.items():
        parts = key.split(".")
        if key.startswith("model.encoder.layers.") and \
                parts[4] == "self_attn":
            key = ".".join(parts[:5] + [names[parts[5]]] + parts[6:])
        elif parts[2:3] == ["layer_norm"]:
            key = f"model.{parts[1]}.layernorm_embedding.{parts[3]}"
        out[key] = v
    for key in ("lm_head.weight", "model.encoder.embed_tokens.weight",
                "model.decoder.embed_tokens.weight"):
        out[key] = sd["model.shared.weight"]
    return out


def synth_scrape(root, seed, n_categories=DATASET_CATEGORIES,
                 n_rows=DATASET_ROWS):
    """A scrape as datasetkit/acquire.py's search_youtube_video leaves it,
    drawn from seed: n_categories query directories ("How to ..."), each
    with a data.csv (videoId, title, timestamp: the chapter lines joined
    by TIMESTAMP_DELIMITER) of n_rows / n_categories rows and a
    subtitle_<vid>.json a row (an entry {text, start, duration} every 10
    s). Drawn so that each merge filter drops some rows: durations of
    60-2400 s (above 1800 dropped), 1-8 chapters (fewer than 3 dropped), a
    first chapter after 0 s in one video of ten, 0.2 or 2-3 words of
    speech a second (below 0.5 dropped); half the chapter titles are the
    first words spoken at the chapter's start. Returns {"queries": the query of
    each directory, "durations": vid -> seconds, "pages": wikihow
    category page url -> html listing the queries of that category (every
    query but the last two has one)}."""
    import json

    import numpy as np
    import pandas as pd

    from video_chapter_generation_tpu_torch.datasetkit.parsing import (
        TIMESTAMP_DELIMITER,
    )
    from video_chapter_generation_tpu_torch.datasetkit.topics import (
        WIKIHOW_SUBJECTS,
        WIKIHOW_WEBSITE,
    )

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(rng.choice(letters, rng.integers(2, 9)))
                      for _ in range(500)])

    def words(n):
        return " ".join(vocab[rng.integers(0, len(vocab), n)])

    def stamp(sec):
        h, m, s = sec // 3600, sec // 60 % 60, sec % 60
        return f"{h}:{m:02d}:{s:02d}" if h else f"{m}:{s:02d}"

    queries = [f"How to {words(2)}" for _ in range(n_categories)]
    durations, per_cat = {}, n_rows // n_categories
    for c, query in enumerate(queries):
        cat_dir = Path(root) / query
        cat_dir.mkdir(parents=True)
        rows = {"videoId": [], "title": [], "timestamp": []}
        for i in range(per_cat):
            vid = f"v{c:02d}x{i:05d}"
            dur = float(round(rng.uniform(60, 2400), 2))
            n_ch = int(rng.integers(1, 9))
            first = 0 if rng.random() >= 0.1 else int(rng.integers(5, 30))
            secs = np.sort(rng.choice(np.arange(first + 1, int(dur) - 1),
                                      n_ch - 1, replace=False))
            rate = 0.2 if rng.random() < 0.1 else rng.uniform(2, 3)
            subs = [{"text": words(max(1, int(rate * 10))),
                     "start": float(t), "duration": 10.0}
                    for t in range(0, int(dur), 10)]
            lines = []
            for t in [first, *secs]:  # half the titles are spoken words
                n_w = int(rng.integers(1, 6))
                said = subs[int(t) // 10]["text"].split()[:n_w]
                lines.append(f"{stamp(int(t))} " + (
                    " ".join(said) if rng.random() < 0.5 else words(n_w)))
            (cat_dir / f"subtitle_{vid}.json").write_text(json.dumps(subs))
            rows["videoId"].append(vid)
            rows["title"].append(f"{query}, part {i}")
            rows["timestamp"].append(TIMESTAMP_DELIMITER.join(lines))
            durations[vid] = dur
        pd.DataFrame(rows).to_csv(cat_dir / "data.csv")
    pages = {}
    for c in range(n_categories - 2):
        subject = WIKIHOW_SUBJECTS[c // 2]
        pages.setdefault(WIKIHOW_WEBSITE + subject, "")
        pages[WIKIHOW_WEBSITE + subject] += (
            f'<div class="responsive_thumb_title"><p>{queries[c]}</p></div>')
    return {"queries": queries, "durations": durations, "pages": pages}


def datasetkit_phase(smi):
    """The dataset kit on the host: a synthetic scrape (synth_scrape, from
    SEED) under a temporary directory of the build directory; topics
    (wikihow pages through an injected http_get, queries to categories,
    vids to categories), merge (durations through duration_fn), filtering,
    split (its main), the merged CSV through data/corpus.py, the ROUGE
    easy/hard split of ROUGE_VIDS test videos, sampler (half of each category to
    its own statistics) and stats. Checks that every merged row passes
    keep_video, that the three split files partition the merged vids,
    that the corpus reads the merged rows back, and that each gated stage
    whose dependency this machine lacks raises its RuntimeError naming
    it; prints which were present. Returns its laps."""
    import glob
    import importlib.util
    import shutil
    import tempfile

    from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
    from video_chapter_generation_tpu_torch.datasetkit import (
        acquire,
        filtering,
        merge,
        sampler,
        split,
        stats,
        topics,
    )
    from video_chapter_generation_tpu_torch.datasetkit.parsing import (
        parse_csv_to_list,
    )

    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="datasetkit_", dir=build))
    laps = {}

    def lap(name, t0):
        laps[name] = round(time.time() - t0, 3)
        return time.time()

    try:
        deps = {name: importlib.util.find_spec(name) is not None
                for name in ("pandas", "cv2", "PIL", "requests",
                             "youtube_transcript_api", "yt_dlp")}
        deps["ffmpeg"] = shutil.which("ffmpeg") is not None
        print(f"# datasetkit dependencies present: {json.dumps(deps)}",
              flush=True)
        t0 = time.time()
        scrape = root / "scrape"
        info = synth_scrape(scrape, SEED)
        durations = info["durations"]
        t0 = lap("synth_scrape", t0)

        # topics: category pages -> queries -> the vids' categories
        cat2q = topics.scrape_wikihow_queries(
            subjects=topics.WIKIHOW_SUBJECTS, http_get=info["pages"].get)
        q2c, counts = topics.assign_query_categories(info["queries"], cat2q)
        asr_files = sorted(glob.glob(str(scrape / "*" / "subtitle_*.json")))
        asr_of = {topics.subtitle_path_query(p)[1]: p for p in asr_files}
        every = topics.categorize_vids(asr_files, q2c)
        if sorted(v for vs in every.values() for v in vs) != \
                sorted(durations) or counts["unknown"] != 2:
            fail(f"topics categorized {sum(map(len, every.values()))} of "
                 f"{len(durations)} vids, counts {counts}")
        t0 = lap("topics", t0)

        # merge: durations through duration_fn (no video files)
        vid2duration = merge.collect_video_durations(
            [str(root / "videos" / f"{vid}.mp4") for vid in durations],
            duration_fn=lambda p: durations[Path(p).stem])
        merged = root / "all_in_one_with_subtitle.csv"
        n = merge.combine_all_data_with_subtitle(asr_files, vid2duration,
                                                 str(merged))
        vids, _, durs, stamps = parse_csv_to_list(str(merged))
        subs = {v: json.loads(Path(asr_of[v]).read_text()) for v in vids}
        kept = sum(merge.keep_video(d, subs[v], s)
                   for v, d, s in zip(vids, durs, stamps))
        if not (0 < n == len(vids) == kept < len(durations)):
            fail(f"merge wrote {n} rows ({len(vids)} read back, {kept} "
                 f"passing keep_video) of {len(durations)}")
        t0 = lap("merge", t0)

        # filtering
        rows = [{"vid": v, "duration": d, "timestamp_lines": s}
                for v, d, s in zip(vids, durs, stamps)]
        kept_rows, removed = filtering.filter_videos(rows)
        if len(kept_rows) + len(removed) != len(rows) or not kept_rows:
            fail(f"filter_videos kept {len(kept_rows)}, removed "
                 f"{len(removed)} of {len(rows)}")
        t0 = lap("filtering", t0)

        # split: its main on the merged CSV, read back as the corpus does
        out_dir = root / "splits"
        with contextlib.redirect_stdout(io.StringIO()):
            split.main(["--data_file", str(merged), "--out_dir",
                        str(out_dir)])
        parts = {name: (out_dir / f"{name}.txt").read_text().split()
                 for name in ("train", "val", "test")}
        joined = [v for part in parts.values() for v in part]
        if sorted(joined) != sorted(vids) or len(set(joined)) != len(vids):
            fail(f"the split files {({k: len(v) for k, v in parts.items()})}"
                 f" do not partition the {len(vids)} merged vids")
        t0 = lap("split", t0)

        # the merged CSV and the test split through data/corpus.py
        corpus = VideoCorpus.from_files(str(root / "frames"), str(merged),
                                        str(out_dir / "test.txt"),
                                        str(scrape))
        if corpus.vids != parts["test"] or any(
                corpus.records[v].duration != vid2duration[v]
                or corpus.subtitles(v) != subs[v] for v in corpus.vids):
            fail("data/corpus.py did not read the merged rows back")
        bad = filtering.find_bad_vids(corpus)
        # the ROUGE split of ROUGE_VIDS of them (its best-window search
        # costs 0.6-1.3 s of host time a video of this scrape)
        few = VideoCorpus(corpus.records, corpus.vids[:ROUGE_VIDS],
                          corpus.img_dir, corpus.asr_files)
        easy, hard = split.rouge_upper_bound_split(few)
        if bad != corpus.vids or sorted(easy + hard) != sorted(few.vids):
            fail(f"find_bad_vids {len(bad)} (no frames: every vid), ROUGE "
                 f"split {len(easy)} + {len(hard)} of {len(few)}")
        t0 = lap("corpus", t0)

        # sampler: half of each category to that category's statistics
        vid2row = {r["vid"]: r for r in rows}
        cat2vid = topics.categorize_vids(asr_files, q2c, valid_vids=vids)
        targets = {c: dict(sampler.stats_for_videos(vs, vid2row),
                           video_count=len(vs) // 2)
                   for c, vs in cat2vid.items() if len(vs) >= 4}
        samp = sampler.DatasetSampler(cat2vid, targets, vid2row, seed=SEED)
        n_ok = samp.sample_all_categories()
        samp.save_results(str(root / "sampled.json"),
                          str(root / "sampled_stats.json"))
        back = json.loads((root / "sampled.json").read_text())
        if n_ok != len(targets) or any(
                len(back[c]) != targets[c]["video_count"]
                or not set(back[c]) <= set(cat2vid[c]) for c in targets):
            fail(f"the sampler matched {n_ok} of {len(targets)} categories")
        t0 = lap("sampler", t0)

        # stats
        vstats = stats.video_stats(rows)
        cstats = stats.clips_per_video(rows)
        vocab = stats.subtitle_vocab(corpus)
        if vstats["num_videos"] != len(rows) or not cstats["total_clips"] \
                or not vocab:
            fail(f"stats: {vstats['num_videos']} videos, {cstats}, "
                 f"{len(vocab)} words")
        t0 = lap("stats", t0)

        # the gated stages: each whose dependency is missing raises its
        # RuntimeError (none that is present is called: they would reach
        # the network or need a real video)
        gated = {
            "requests": lambda: acquire._default_http_get(
                acquire.YOUTUBE_VIDEO_URL, {}),
            "youtube_transcript_api": lambda: acquire.fetch_asr("vid"),
            "yt_dlp": lambda: acquire.download_video("vid", str(root)),
            "ffmpeg": lambda: acquire.extract_frames(
                str(root / "none.mp4"), str(root / "frames")),
            "cv2": lambda: merge.video_duration(str(root / "none.mp4")),
        }
        raised = {}
        for dep, call in gated.items():
            if deps[dep]:
                continue
            try:
                call()
            except RuntimeError as exc:
                raised[dep] = str(exc)
            if dep.split("_")[0] not in raised.get(dep, ""):
                fail(f"the {dep} stage did not raise its RuntimeError "
                     f"({raised.get(dep)!r})")
        if deps["cv2"] and merge.video_duration(str(root / "none.mp4")) \
                is not None:
            fail("video_duration read a duration from a missing file")
        resized = None
        if deps["PIL"]:
            from PIL import Image

            img_dir = root / "frames" / corpus.vids[0]
            img_dir.mkdir(parents=True)
            for i in range(4):
                Image.new("RGB", (224, 224), (i, 2 * i, 3 * i)).save(
                    img_dir / f"{i + 1:05d}.jpg")
            resized = topics.resize_frames(str(img_dir))
            if resized != 4 or Image.open(img_dir / "00001.jpg").size != \
                    (96, 96):
                fail(f"topics.resize_frames wrote {resized} files")
        lap("gated", t0)
        print(f"# datasetkit: {len(durations)} scraped videos in "
              f"{len(info['queries'])} categories ({counts['unknown']} "
              f"queries unknown) -> {n} merged rows (all pass keep_video) -> "
              f"filter_videos kept {len(kept_rows)}; split "
              f"{({k: len(v) for k, v in parts.items()})}; corpus of the "
              f"test split {len(corpus)} vids, ROUGE easy {len(easy)} hard "
              f"{len(hard)} of its first {len(few)}; sampler {n_ok} of {len(targets)} categories; "
              f"{cstats['total_clips']} clips, {len(vocab)} subtitle words; "
              f"gated stages raising: {sorted(raised)}; resize_frames "
              f"{resized}; laps {json.dumps(laps)} (the host of {smi})",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return laps


def hf_import_phase(dev, smi, big, ids, mask, enc):
    """The HuggingFace weight imports at full width on the card. ResNet-50
    (frames stem, T 16, bf16; seeded weights through the from_jax table):
    its state dict renamed into HF ResNetModel keys (resnet_to_hf) and
    imported back by convert_hf_resnet equals it and loads strictly, and
    one 16-frame vision call of the imported trunk (K8 1, K2/K3 13, K4 3,
    exact) gives the torchvision-layout trunk's features bit for bit; its
    kernels held to their plain versions on that call's own arguments.
    The bigbird phase's BigBird-Pegasus-large (big), renamed into HF
    BigBirdPegasus keys (bigbird_to_hf) and imported back by
    convert_hf_seq2seq, loads strictly and encodes that phase's ids and
    mask to its encoder states (enc) bit for bit, with K10 launched once a
    layer on the wgmma kernel, held on its first launch's arguments.
    Returns the kernels-line entries of the two paths."""
    import torch

    from video_chapter_generation_tpu_torch.models import convert
    from video_chapter_generation_tpu_torch.models import (
        resnet as resnet_model,
    )
    from video_chapter_generation_tpu_torch.models import (
        sparse_attention as sparse_model,
    )
    from video_chapter_generation_tpu_torch.models.convert_hf import (
        convert_hf_resnet,
        convert_hf_seq2seq,
    )
    from video_chapter_generation_tpu_torch.models.resnet import (
        STAGE_SIZES,
        ResNet,
    )
    from video_chapter_generation_tpu_torch.models.seq2seq import Seq2Seq
    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
    )
    from video_chapter_generation_tpu_torch.ops.stem import stem_frames
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )

    bf = torch.bfloat16
    sizes = STAGE_SIZES[50]
    serving = (stem_frames, tsm_bottleneck, tsm_bottleneck_s2)
    vision_call = {"stem_frames": 1, "tsm_bottleneck": 13,
                   "tsm_bottleneck_s2": 3}

    def trunk(sd):
        with torch.device("meta"):
            m = ResNet(50, n_segment=CLIP_FRAMES, dtype=bf)
        m.load_state_dict(sd, strict=True, assign=True)
        return m.to(dev).eval()

    def same(a, b):
        return a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)

    # --- ResNet-50 through HF ResNetModel's keys ---
    with torch.device("meta"):
        shape = ResNet(50, n_segment=CLIP_FRAMES, dtype=bf)
    tv_sd = convert.from_jax_resnet(convert.random_jax_tree(
        shape, convert.resnet_entries(sizes), seed=HF_IMPORT_SEED), sizes)
    t0 = time.time()
    hf_sd = convert_hf_resnet(resnet_to_hf(tv_sd))
    rn_import_s = time.time() - t0
    if not same(hf_sd, tv_sd):
        fail("convert_hf_resnet did not give the torchvision-layout dict")
    tv, imported = trunk(tv_sd), trunk(hf_sd)
    gen = torch.Generator(device=dev).manual_seed(HF_IMPORT_SEED)
    frames = torch.randn(CLIP_FRAMES, 224, 224, 3, generator=gen,
                         device=dev).to(bf)
    want = tv(frames)
    for f in serving:
        f.launches = 0
    with first_calls({(resnet_model, name): n
                      for name, n in vision_call.items()}) as kept:
        got = imported(frames)
        torch.cuda.synchronize()
    rn_seen = {f.__name__: f.launches for f in serving}
    print(f"# hf_import ResNet-50 via HF ResNetModel keys "
          f"({len(hf_sd)} tensors, imported in {rn_import_s:.2f} s): a "
          f"{tuple(frames.shape)} bf16 vision call, launches {rn_seen}, "
          f"features bit for bit the torchvision-layout load's "
          f"{torch.equal(got, want)}", flush=True)
    if rn_seen != vision_call:
        fail(f"the imported ResNet's launches {rn_seen} != {vision_call}")
    if not torch.equal(got, want):
        fail("the HF-imported ResNet-50's features differ from the "
             "torchvision-layout load's")
    rn_rows = hold_vision_call(kept)
    del kept, tv, imported, tv_sd, hf_sd, want, got

    # --- the bigbird phase's model through HF BigBirdPegasus's keys ---
    cfg = big.cfg
    src = big.state_dict()
    t0 = time.time()
    bb_sd = convert_hf_seq2seq(bigbird_to_hf(src), cfg)
    bb_import_s = time.time() - t0
    if not same(bb_sd, {k: v.cpu() for k, v in src.items()}):
        fail("convert_hf_seq2seq did not give the port's BigBird dict")
    with torch.device("meta"):
        m = Seq2Seq(cfg)
    m.load_state_dict(bb_sd, strict=True, assign=True)
    m.to(dev).eval()
    del bb_sd, src
    sparse_band_attention.launches = 0
    sparse_band_attention.serving_launches = 0
    with first_calls({(sparse_model, "sparse_band_attention"): 1}) as kept:
        enc2 = m.encode(ids, mask)
        torch.cuda.synchronize()
    bb_launches = sparse_band_attention.launches
    serving = sparse_band_attention.serving_launches
    print(f"# hf_import BigBird-Pegasus-large via HF BigBirdPegasus keys "
          f"(imported in {bb_import_s:.2f} s): encode {tuple(ids.shape)}, "
          f"K10 launches {bb_launches} ({serving} serving), encoder states "
          f"bit for bit the bigbird phase's {torch.equal(enc2, enc)}",
          flush=True)
    if bb_launches != cfg.encoder_layers or serving != bb_launches:
        fail(f"the imported BigBird launched K10 {bb_launches} times "
             f"({serving} on the serving kernel), not {cfg.encoder_layers} "
             f"on the serving kernel")
    if not torch.equal(enc2, enc):
        fail("the HF-imported BigBird's encoder states differ")
    (q_mid, k, v, kmask, tab_ids, valid, bs, _), _ = \
        kept["sparse_band_attention"][0]
    del kept, m, enc2
    k10 = hold_k10(q_mid, k, v, kmask, (tab_ids, valid), bs,
                   "sparse_band_attn", "the imported BigBird's first launch",
                   smi)
    del q_mid, k, v
    torch.cuda.empty_cache()

    sources = {"stem_frames": ("csrc/stem_s2d.cu", "stem_pallas.py:255"),
               "tsm_bottleneck": ("csrc/tsm_bottleneck.cu",
                                  "tsm_block_pallas.py:1094"),
               "tsm_bottleneck_s2": ("csrc/tsm_bottleneck.cu",
                                     "tsm_block_pallas.py:654"),
               "sparse_band_attention": ("csrc/sparse_attention.cu",
                                         "sparse_attention_pallas.py:108")}

    def entry(name, launches, row, path):
        src_file, replaces = sources[name]
        return dict(name=name, route="cuda",
                    source=f"video_chapter_generation_tpu_torch/{src_file}",
                    replaces=f"video_chapter_generation_tpu/ops/{replaces}",
                    launches=launches, **row, path=path)

    return [entry(name, rn_seen[name], row,
                  "hf_import: convert_hf_resnet, a 16-frame vision call")
            for name, row in rn_rows.items()] + [
        entry("sparse_band_attention", bb_launches, k10,
              "hf_import: convert_hf_seq2seq, a BigBird encode")]


def bigbird_phases(dev, smi, cli_argv):
    """K10 against its plain version at the BigBird-Pegasus serving shape,
    greedy titles of the full-width BigBird model, cli/infer_video
    --title_arch bigbird at 3072 tokens, and one BART-large generate.
    Returns K10's JSON entries (the serving, ring and mma.sync kernels')
    and, for the hf_import phase, the BigBird model with the ids
    and mask of its encode and the encoder states."""
    import os

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import infer_video
    from video_chapter_generation_tpu_torch.models import convert
    from video_chapter_generation_tpu_torch.models.seq2seq import (
        Seq2Seq,
        Seq2SeqConfig,
        generate,
    )
    from video_chapter_generation_tpu_torch.models.sparse_attention import (
        _tables,
        block_sparse_attention,
    )
    from video_chapter_generation_tpu_torch.ops import sparse_attention as sa
    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
    )

    bf = torch.bfloat16

    def build(cfg, seed):
        t0 = time.time()
        with torch.device("meta"):
            m = Seq2Seq(cfg)
        entries = convert.seq2seq_entries(cfg)
        tree = convert.random_jax_tree(m, entries, seed=seed)
        m.load_state_dict(convert.from_jax_seq2seq(tree, cfg), assign=True)
        m.to(dev, bf).eval()
        print(f"# {type(m).__name__} d_model {cfg.d_model}, "
              f"{cfg.encoder_layers}+{cfg.decoder_layers} layers, vocab "
              f"{cfg.vocab_size}: ready in {time.time() - t0:.1f} s",
              flush=True)
        return m

    def timed_generate(m, ids, mask, label):
        out = generate(m, ids, mask, max_len=TITLE_OUT)
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            generate(m, ids, mask, max_len=TITLE_OUT)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        if tuple(out.shape) != (ids.shape[0], TITLE_OUT) or \
                int(out.min()) < 0 or int(out.max()) >= m.cfg.vocab_size:
            fail(f"{label} generate gave ids outside the vocabulary")
        print(f"# {label} greedy titles, batch {ids.shape[0]}, encoder "
              f"{ids.shape[1]}, {TITLE_OUT} steps: "
              f"{sorted(times)[1] / TITLE_OUT:.3f} ms per step (encoder "
              f"included, median of 3) on {smi}; first ids "
              f"{out[0, :8].tolist()}", flush=True)
        return out

    cfg = Seq2SeqConfig.bigbird_pegasus_large()
    big = build(cfg, SEED + 11)
    b, l, bs = BIGBIRD_BATCH, BIGBIRD_IN, cfg.block_size
    h, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    nb = l // bs
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    ids = torch.randint(3, cfg.vocab_size, (b, l), generator=gen, device=dev)
    lens = np.linspace(BIGBIRD_MIN_LEN, l, b).astype(int)
    mask = (torch.arange(l, device=dev)[None]
            < torch.from_numpy(lens).to(dev)[:, None]).to(torch.int32)
    ids = ids * mask

    # --- K10 at the serving shape: q, k, v of encoder layer 0 ---
    layer = big.model.encoder.layers[0]
    with torch.no_grad():
        x = layer.self_attn_layer_norm(big._embed(
            big.model.encoder, ids, torch.arange(l, device=dev)[None]))
        q, k, v = [proj(x).reshape(b, l, h, hd) for proj in (
            layer.self_attn.q_proj, layer.self_attn.k_proj,
            layer.self_attn.v_proj)]
    tabs = _tables(nb, cfg.num_rand_blocks, 0, None, dev)
    q_mid = q[:, bs:l - bs]

    def counts():
        return [getattr(sparse_band_attention, f"{r}_launches")
                for r in sa.ROUTES]

    def ran(before):  # the kernels whose counters moved since `before`
        return [r for r, a, z in zip(sa.ROUTES, before, counts()) if z != a]

    before = counts()
    row = hold_k10(q_mid, k, v, mask, tabs, bs, "sparse_band_attn",
                   f"rows valid for {lens.tolist()} tokens", smi)
    if ran(before) != ["serving"]:
        fail(f"the serving shape ran K10's {ran(before)}, not the serving "
             f"kernel")

    # --- K10 at every other class of shape, on its route's kernel (the
    # ring or the mma.sync kernel): the same bytes (q, k, v of layer 0) in
    # other tables and head splits ---
    other_rows = {"ring": [], "mma_sync": []}
    for label, bsr, heads, r in K10_OTHER_SHAPES:
        hdr = h * hd // heads
        qr, kr, vr = [t.reshape(b, l, heads, hdr) for t in (q, k, v)]
        tabs_r = _tables(l // bsr, r, 0, None, dev)
        route = sa.ROUTES[sa._route(bsr, hdr, int(tabs_r[0].shape[1]),
                                    l // bsr - 2)]
        before = counts()
        got = hold_k10(qr[:, bsr:l - bsr], kr, vr, mask, tabs_r, bsr,
                       f"sparse_band_{route}", f"{label}: H {heads} hd {hdr}",
                       smi)
        if route == "serving" or ran(before) != [route]:
            fail(f"sparse_band_attention at {label} ran {ran(before)}, not "
                 f"the ring or the mma.sync kernel its route names")
        other_rows[route].append(dict(
            shape=label, b=b, l=l, h=heads, hd=hdr, bs=bsr,
            parts=int(tabs_r[0].shape[1]),
            table_entries=int(tabs_r[0].numel()), **got))
    for route, held in other_rows.items():
        if not held:
            fail(f"no held K10 shape ran the {route} kernel")

    # the whole block-sparse attention (kernel, first/last blocks, padded
    # rows zeroed) on the card vs the plain float32 form on the CPU, for
    # the shortest and the longest row
    rows = [0, b - 1]
    got = block_sparse_attention(q[rows], k[rows], v[rows], mask[rows],
                                 bs, cfg.num_rand_blocks)
    want = block_sparse_attention(
        *(t[rows].float().cpu() for t in (q, k, v)), mask[rows].cpu(), bs,
        cfg.num_rand_blocks)
    w_abs, w_rel, w_cos = compare(got.cpu(), want)
    print(f"# block_sparse_attention, rows of {lens[0]} and {lens[-1]} "
          f"tokens, kernel bf16 vs plain float32 on the CPU: max_abs "
          f"{w_abs:.4g} mean_rel {w_rel:.3g} cos {w_cos:.6f}", flush=True)
    if not (w_cos >= KERNEL_MIN_COS and w_rel <= KERNEL_MAX_MEAN_REL):
        fail("block_sparse_attention on the card disagrees with the CPU")
    del q, k, v, x, q_mid

    # --- greedy titles from 3072-token inputs: 16 K10 launches an encode,
    # all on the serving kernel ---
    sparse_band_attention.launches = 0
    sparse_band_attention.serving_launches = 0
    with torch.no_grad():
        enc = big.encode(ids, mask)
    torch.cuda.synchronize()
    if sparse_band_attention.launches != cfg.encoder_layers:
        fail(f"one encode launched K10 {sparse_band_attention.launches} "
             f"times, not {cfg.encoder_layers}")
    if sparse_band_attention.serving_launches != cfg.encoder_layers:
        fail("the serving shape ran another K10 kernel than the serving one")
    if not torch.isfinite(enc.float()).all():
        fail("the BigBird encoder states are not finite")
    timed_generate(big, ids, mask, "BigBird-Pegasus-large bf16")

    # --- cli/infer_video --title_arch bigbird at 3072 tokens ---
    build_dir = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    for r_ in sa.ROUTES:
        setattr(sparse_band_attention, f"{r_}_launches", 0)
    sparse_band_attention.launches = 0
    cwd = os.getcwd()
    os.chdir(build_dir)
    said = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(said):
            results = infer_video.main(cli_argv + [
                "--title_arch", "bigbird", f"data.title_input_len={l}",
                "--pipelined"])
    finally:
        os.chdir(cwd)
        for line in said.getvalue().splitlines():
            print(f"# cli: {line}", flush=True)
    torch.cuda.synchronize()
    launches = sparse_band_attention.launches
    by_route = {r_: getattr(sparse_band_attention, f"{r_}_launches")
                for r_ in sa.ROUTES}
    wall = time.time() - t0
    batches = sum(1 for r in results.values() if r.spans)
    print(f"# infer_video --title_arch bigbird data.title_input_len={l} "
          f"--pipelined: {len(results)} videos, {batches} title batches, "
          f"K10 launches {launches} (by kernel {by_route}), "
          f"{wall:.1f} s (models and restore "
          f"included) on {smi}", flush=True)
    if "restored checkpoint at epoch 0" not in said.getvalue():
        fail("infer_video did not restore the checkpoint")
    if launches != cfg.encoder_layers * batches \
            or by_route["serving"] != launches:
        fail(f"infer_video launched K10 {launches} times ({by_route}) for "
             f"{batches} title batches, not {cfg.encoder_layers} each on "
             f"the serving kernel")
    for vid, r in results.items():
        if not r.cut_points or len(r.titles) != len(r.spans):
            fail(f"{vid}: {len(r.cut_points)} cut points, "
                 f"{len(r.titles)} titles for {len(r.spans)} chapters")
    torch.cuda.empty_cache()

    # --- BART-large: one greedy generate at full width ---
    bart = build(Seq2SeqConfig.bart_large(), SEED + 17)
    ids_b = torch.randint(3, bart.cfg.vocab_size, (TITLE_BUCKET, TITLE_IN),
                          generator=gen, device=dev)
    timed_generate(bart, ids_b, torch.ones_like(ids_b), "BART-large bf16")
    del bart
    torch.cuda.empty_cache()

    # launches from the CLI run, split by the kernel they ran
    src = "video_chapter_generation_tpu_torch/csrc/sparse_attention.cu"
    tpu = "video_chapter_generation_tpu/ops/sparse_attention_pallas.py:108"
    # the ring and the mma.sync kernels' numbers: the first shape each
    # takes; every shape it took under "held"
    return [{"name": "sparse_band_attention", "route": "cuda",
             "source": src, "replaces": tpu,
             "launches": by_route["serving"], **row}] + [
        {"name": f"sparse_band_attention_{route}", "route": "cuda",
         "source": src, "replaces": tpu, "launches": by_route[route],
         **{k_: v_ for k_, v_ in held[0].items() if k_ in row},
         "held": held} for route, held in other_rows.items()], \
        (big, ids, mask, enc)


def window_phases(dev, smi, frames, vision):
    """K5, K6 and K7 against their plain versions at the shapes of one
    256-frame vision call (and K5's training entry at one 128-frame step),
    then the window model: cli/train_segment.main on the default config
    under tsm_impl auto and pallas, and window scoring through
    build_score_fn under auto, fusedblk, pallas and fuse_tsm=False.
    Returns the kernels' JSON entries."""
    import shutil

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import train_segment
    from video_chapter_generation_tpu_torch.cli.common import (
        load_bert_tokenizer,
        load_corpus,
        parse_config,
    )
    from video_chapter_generation_tpu_torch.cli.eval_segment import (
        build_score_fn,
    )
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.data.clip_grid import (
        flatten_video_to_clips,
    )
    from video_chapter_generation_tpu_torch.data.datasets import (
        InferWindowClipDataset,
    )
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.models.fusion import (
        TwoStreamWindow,
    )
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        affine_consts,
        depth_to_space4,
        normalize_frames,
        normalize_frames_reference,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        bn_relu_maxpool,
        stem_frames,
        stem_s2d,
    )
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_train_bwd,
        stem_train_fwd,
    )
    from video_chapter_generation_tpu_torch.ops.temporal_shift import (
        temporal_shift,
        temporal_shift_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        block_train_bwd,
        block_train_fwd,
        finale_bwd,
        finale_fwd,
        trunk_link_bwd,
        trunk_link_fwd,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_conv import (
        tsm_conv1x1,
        tsm_conv1x1_bn_relu,
        tsm_conv1x1_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_trunk_train import (
        recompute_p,
    )
    from video_chapter_generation_tpu_torch.pipeline.boundary import (
        score_clips,
    )
    from video_chapter_generation_tpu_torch.train.tasks import (
        SegmentWindowTask,
    )

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    entries = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "flops": 0.0, "bytes": 0.0, "max_abs": 0.0}
               for k in ("tsm_conv1x1_bn_relu", "tsm_conv1x1",
                         "normalize_frames", "temporal_shift")}

    def account(name, got, ref, k_ms, p_ms, flops, nbytes, lib_ms=0.0):
        e = entries[name]
        e["max_abs"] = max(e["max_abs"], compare(got, ref)[0])
        e["ms"] += k_ms
        e["plain_ms"] += p_ms
        e["library_ms"] += lib_ms
        e["flops"] += flops
        e["bytes"] += nbytes

    # the input of every block of one 256-frame vision call, on the
    # serving trunk's kernels (each block fed the kernel output of the last)
    stem_p, block_ps = vision.folded_params()
    y = stem_s2d(frames, stem_p["w7"], stem_p["s"], stem_p["b"])
    inputs = []
    for blk, p in zip(vision.blocks(), block_ps):
        inputs.append(y)
        y = blk.run(y, p, CLIP_FRAMES, 8)
    del y

    # --- K5: the conv1 of every block, with and without the epilogue ---
    for i, (x, p) in enumerate(zip(inputs, block_ps)):
        nt, h, w, c = x.shape
        f = p["w1"].shape[1]
        m = nt * h * w
        label = f"block {i:2d} {tuple(x.shape)} -> F={f}"
        ep = (p["s1"], p["b1"])
        runs = {
            "tsm_conv1x1_bn_relu": (
                lambda x=x, p=p, ep=ep: tsm_conv1x1_bn_relu(
                    x, p["w1"], *ep, CLIP_FRAMES),
                lambda x=x, p=p, ep=ep: tsm_conv1x1_reference(
                    x, p["w1"], CLIP_FRAMES, 8, *ep, relu=True)),
            "tsm_conv1x1": (
                lambda x=x, p=p: tsm_conv1x1(x, p["w1"], CLIP_FRAMES),
                lambda x=x, p=p: tsm_conv1x1_reference(x, p["w1"],
                                                       CLIP_FRAMES))}
        # the library yardstick: the GEMM part only, on a pre-shifted x
        xs = temporal_shift_reference(x, CLIP_FRAMES, 8).reshape(m, c)
        lib_ms = cuda_ms(lambda xs=xs, p=p: torch.matmul(xs, p["w1"]))
        notes = []
        for name, (kernel, plain) in runs.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            max_abs, mean_rel, cos = compare(got, ref)
            if not (cos >= KERNEL_MIN_COS and mean_rel <= KERNEL_MAX_MEAN_REL):
                fail(f"{name} {label} disagrees with its plain version: "
                     f"max_abs {max_abs:.4g} mean_rel {mean_rel:.3g} cos "
                     f"{cos:.6f}")
            k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
            account(name, got, ref, k_ms, p_ms, 2 * m * c * f,
                    2 * (m * c + c * f + m * f) + 8 * f, lib_ms)
            notes.append(f"{name} cos {cos:.6f} mean_rel {mean_rel:.3g} "
                         f"kernel {k_ms:.3f} ms plain {p_ms:.3f}")
        print(f"# {'tsm_conv1x1':18s} {label:36s} {' | '.join(notes)} | "
              f"GEMM part alone (torch.matmul, pre-shifted) {lib_ms:.3f} ms",
              flush=True)
        del xs

    # K5's training entry at one 128-frame step: the backward (dX by a
    # matmul and the reverse K7 shift, dW by K7 and a matmul) against
    # autograd through the plain version, in the gradient bands
    n_train = TRAIN_CLIPS * CLIP_FRAMES
    bwd_k = bwd_p = 0.0
    for i, (x, p, blk) in enumerate(zip(inputs, block_ps, vision.blocks())):
        x = x[:n_train].contiguous()
        w32 = blk.conv1.weight.detach()[:, :, 0, 0].t().contiguous()
        xk, wk = x.clone().requires_grad_(), w32.clone().requires_grad_()
        yk = tsm_conv1x1(xk, wk, CLIP_FRAMES)
        dy = torch.randn(yk.shape, generator=gen, device=dev).to(bf)
        xr, wr = x.clone().requires_grad_(), w32.clone().requires_grad_()
        yr = tsm_conv1x1_reference(xr, wr.to(bf), CLIP_FRAMES)
        gk = torch.autograd.grad(yk, [xk, wk], dy, retain_graph=True)
        gr = torch.autograd.grad(yr, [xr, wr], dy, retain_graph=True)
        torch.cuda.synchronize()
        worst = 1.0
        for a, b in zip(gk, gr):
            _, mean_rel, cos = compare(a, b)
            worst = min(worst, cos)
            if not (cos >= GRAD_MIN_COS and mean_rel <= GRAD_MAX_MEAN_REL):
                fail(f"tsm_conv1x1 backward block {i} disagrees with its "
                     f"plain version: mean_rel {mean_rel:.3g} cos {cos:.6f}")
        kb = cuda_ms(lambda: torch.autograd.grad(yk, [xk, wk], dy,
                                                 retain_graph=True))
        pb = cuda_ms(lambda: torch.autograd.grad(yr, [xr, wr], dy,
                                                 retain_graph=True))
        bwd_k += kb
        bwd_p += pb
        print(f"# {'tsm_conv1x1 bwd':18s} block {i:2d} {tuple(x.shape)} "
              f"grads cos >= {worst:.6f} | backward {kb:.3f} ms (2 matmuls "
              f"+ 2 K7) plain autograd {pb:.3f} ms", flush=True)
        del xk, wk, yk, xr, wr, yr, gk, gr
    print(f"# tsm_conv1x1 backward, one 128-frame step (16 blocks): "
          f"{bwd_k:.3f} ms, plain {bwd_p:.3f} ms on {smi}", flush=True)

    # --- K7: forward and reverse shift at every block input, bit for bit ---
    for i, x in enumerate(inputs):
        for reverse in (False, True):
            got = temporal_shift(x, CLIP_FRAMES, 8, reverse)
            ref = temporal_shift_reference(x, CLIP_FRAMES, 8, reverse)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"temporal_shift block {i} reverse={reverse}: not its "
                     f"plain version bit for bit")
        k_ms = cuda_ms(lambda x=x: temporal_shift(x, CLIP_FRAMES))
        p_ms = cuda_ms(lambda x=x: temporal_shift_reference(x, CLIP_FRAMES))
        account("temporal_shift", got, ref, k_ms, p_ms, 0,
                2 * x.numel() * x.element_size())
    print(f"# {'temporal_shift':18s} 16 block inputs, forward and reverse "
          f"bitwise True | forward per vision call: kernel "
          f"{entries['temporal_shift']['ms']:.3f} ms plain "
          f"{entries['temporal_shift']['plain_ms']:.3f} ms", flush=True)
    del inputs

    # --- K6: the decoded frames of one 16-clip call, [16, 16, 224, 224, 3] ---
    u8 = depth_to_space4(frames).reshape(16, CLIP_FRAMES, 224, 224, 3)
    u8 = u8.contiguous()
    for out_dtype in (torch.float32, bf):
        got = normalize_frames(u8, out_dtype)
        ref = normalize_frames_reference(u8, out_dtype)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"normalize_frames to {out_dtype}: not its plain version "
                 f"bit for bit")
        k_ms = cuda_ms(lambda: normalize_frames(u8, out_dtype))
        p_ms = cuda_ms(lambda: normalize_frames_reference(u8, out_dtype))
        if out_dtype == bf:  # the main path's output type
            # the yardstick: one torch.addcmul of the same affine (float32
            # out: a bf16 output would take a second call)
            a3, b3 = affine_consts(dev)
            lib_ms = cuda_ms(lambda: torch.addcmul(b3, u8, a3))
            account("normalize_frames", got, ref, k_ms, p_ms, 2 * u8.numel(),
                    u8.numel() * 3, lib_ms)
        print(f"# {'normalize_frames':18s} {str(tuple(u8.shape)):36s} -> "
              f"{str(out_dtype)[6:]} bitwise True | kernel {k_ms:.3f} ms "
              f"plain {p_ms:.3f} ms"
              + (f" | torch.addcmul (float32 out) {lib_ms:.3f} ms"
                 if out_dtype == bf else ""), flush=True)
    del u8, got, ref
    torch.cuda.empty_cache()

    # --- the window model: train_segment on the default config ---
    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    root = build / "synth_window_corpus"
    paths = make_synth_corpus_on_disk(
        str(root), n_videos=2 * WINDOW_STEPS + 2, video_sec=60,
        seed=SEED + 21, splits={"train": 2 * WINDOW_STEPS, "val": 2})
    base = [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            f"data.val_vid_file={paths['val_vid_file']}",
            "data.batch_size=2", "train.max_epochs=1",
            # epoch 0 warms up at 0.01 of the rate: 1e-5 moves every
            # float32 parameter (1e-7, the default's, leaves a scale of 1.0
            # where it was)
            "optim.learning_rate=1e-3",
            "train.keep_checkpoints=1", "train.resume=false"]
    counted = {f.__name__: f for f in (
        normalize_frames, stem_train_fwd, stem_train_bwd, block_train_fwd,
        block_train_bwd, finale_fwd, finale_bwd, trunk_link_fwd,
        trunk_link_bwd, recompute_p, tsm_conv1x1, temporal_shift,
        stem_frames, bn_relu_maxpool, tsm_bottleneck, tsm_bottleneck_s2,
        tsm_conv1x1_bn_relu)}
    runs, seen = {}, {}

    def drive(fn):
        for f in counted.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counted.items() if f.launches}

    eval_call = {"normalize_frames": 1, "stem_frames": 1,
                 "tsm_bottleneck": 13, "tsm_bottleneck_s2": 3}
    per_step = {
        "auto": {"normalize_frames": 1, "stem_train_fwd": 1,
                 "stem_train_bwd": 1, "block_train_fwd": 16,
                 "block_train_bwd": 16, "finale_fwd": 1, "finale_bwd": 1,
                 "trunk_link_fwd": 15, "trunk_link_bwd": 15,
                 "recompute_p": 16},
        "pallas": {"normalize_frames": 1, "tsm_conv1x1": 16,
                   "temporal_shift": 32}}
    for impl in ("auto", "pallas"):
        ckpt = build / f"window_ckpt_{impl}"
        shutil.rmtree(ckpt, ignore_errors=True)
        argv = base + [f"model.tsm_impl={impl}", f"train.ckpt_dir={ckpt}",
                       f"train.log_dir={build / f'window_logs_{impl}'}"]
        if impl == "auto":  # the AUC/mAP eval once, after the epoch
            argv.append("train.eval_every_epochs=1")
        t0 = time.time()
        trainer, launches = drive(lambda: train_segment.main(argv))
        wall = time.time() - t0
        seen[f"train {impl}"] = launches
        steps = trainer.step
        want = {k: v * steps for k, v in per_step[impl].items()}
        if impl == "auto":
            for k, v in eval_call.items():
                want[k] = want.get(k, 0) + v  # 2 val videos: one batch
        print(f"# window train_segment tsm_impl={impl}: {steps} steps of 2 "
              f"windows (96 frames), {wall:.1f} s (models, data and "
              f"checkpoint included), launches {launches} on {smi}",
              flush=True)
        if not isinstance(trainer.model, TwoStreamWindow) or steps != \
                WINDOW_STEPS:
            fail(f"window training ran {steps} steps of "
                 f"{type(trainer.model).__name__}")
        if launches != want:
            fail(f"window training launch counts {launches} != {want}")
        logs = [json.loads(line) for line in
                open(build / f"window_logs_{impl}" / "scalars.jsonl")]
        tags = {r["tag"]: r["value"] for r in logs}
        if not math.isfinite(tags["train/loss"]):
            fail(f"window training loss {tags['train/loss']} is not finite")
        init = SegmentWindowTask(trainer.cfg).init_state()
        trained = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
        params = {k for k, _ in trainer.model.named_parameters()}
        frozen = [k for k in init if not k.endswith("num_batches_tracked")
                  and torch.equal(init[k], trained[k])]
        # an attention key bias has a zero gradient in exact arithmetic
        # (softmax ignores a per-query constant): it may stay where it was
        bad = [k for k in frozen if not k.endswith("key.bias")]
        print(f"# loss {tags['train/loss']:.4f}"
              + (f", eval auc {tags['eval/auc']:.3f} m_ap "
                 f"{tags['eval/m_ap']:.3f}" if "eval/auc" in tags else "")
              + f"; {len(init) - len(frozen)} of {len(init)} tensors moved "
              f"({len(params)} parameters; unmoved: {frozen[:4]})",
              flush=True)
        if bad:
            fail(f"window training did not move {bad[:4]}")
        _, state = CheckpointManager(str(ckpt)).restore_latest()
        if any(not torch.equal(v, trained[k])
               for k, v in state["model"].items()):
            fail("the window checkpoint does not hold the trained model")
        runs[impl] = (trainer.cfg, argv, trained)
        del trainer, state, init
        torch.cuda.empty_cache()

    # --- window scoring through build_score_fn, one synthetic video ---
    cfg, argv, trained = runs["auto"]
    cfg, args = parse_config(argv)
    tok = load_bert_tokenizer(args, load_corpus(cfg, "train"))
    val = load_corpus(cfg, "val")
    vid = val.vids[0]
    clips = flatten_video_to_clips(vid, val.img_dir, val.image_num(vid),
                                   val.raw_cut_secs(vid), val.subtitles(vid),
                                   CLIP_FRAMES)
    ds = InferWindowClipDataset(clips, tok, CLIP_FRAMES, TEXT_LEN,
                                window_size=1)
    clip = None
    feats = {}
    per_call = {
        "auto": {"tsm_bottleneck": 13, "tsm_bottleneck_s2": 3},
        "fusedblk": {"tsm_bottleneck": 12, "tsm_conv1x1_bn_relu": 4},
        "pallas": {"tsm_conv1x1_bn_relu": 16},
        "fuse_tsm=False": {"temporal_shift": 16}}
    for mode in per_call:
        impl = "pallas" if mode == "fuse_tsm=False" else mode
        score = build_score_fn(cfg.apply_overrides([f"model.tsm_impl={impl}"]),
                               args, tok, device=dev)
        model = score.model
        if mode == "auto":  # the scorer restores the checkpoint bit for bit
            for k, v in model.state_dict().items():
                if not torch.equal(v.cpu(), trained[k].to(v.dtype)):
                    fail(f"build_score_fn restored {k} differently")
        model.vision_model.fuse_tsm = mode != "fuse_tsm=False"
        t0 = time.time()
        infos, launches = drive(lambda: score_clips(ds, score, WINDOW_BATCH,
                                                    prefetch=0))
        wall = time.time() - t0
        seen[f"score {mode}"] = launches
        calls = math.ceil(len(ds) / WINDOW_BATCH)
        want = {k: v * calls for k, v in dict(
            per_call[mode], normalize_frames=1, stem_frames=1).items()}
        probs = np.asarray([c.pred_score for c in infos], np.float64)
        print(f"# window scoring {mode}: {len(ds)} windows of 3 x "
              f"{CLIP_FRAMES} frames in {calls} vision calls of "
              f"{WINDOW_BATCH * 3 * CLIP_FRAMES} frames, {wall:.2f} s, "
              f"probabilities {probs.min():.4f}..{probs.max():.4f}, "
              f"launches {launches}", flush=True)
        if launches != want:
            fail(f"window scoring {mode} launch counts {launches} != {want}")
        if not (np.isfinite(probs).all() and (probs >= 0).all()
                and (probs <= 1).all()):
            fail(f"window scoring {mode}: probabilities outside [0, 1]")
        if clip is None:
            clip = normalize_frames(torch.from_numpy(
                ds[0]["img_clips"][1]).to(dev), bf)
        with torch.no_grad():
            feats[mode] = model.vision_model(clip).float()
        del score, model
        torch.cuda.empty_cache()
    for mode, f in feats.items():
        cos = torch.nn.functional.cosine_similarity(f, feats["auto"], dim=1)
        print(f"# vision trunk {mode} vs auto, one clip: per-frame cosine "
              f"min {cos.min().item():.6f}", flush=True)
        if cos.min().item() < WINDOW_TRUNK_MIN_COS:
            fail(f"the {mode} trunk disagrees with the auto kernel trunk")
    # the auto checkpoint stays for the evaluation phase, with the
    # training vocabulary that its contract's vocab_hash names
    shutil.rmtree(build / "window_ckpt_pallas", ignore_errors=True)
    vocab = build / "window_vocab.txt"
    vocab.write_text("\n".join(sorted(tok.vocab, key=tok.vocab.get)) + "\n")

    sources = {
        "tsm_conv1x1_bn_relu": ("csrc/tsm_conv.cu", "tsm_conv_pallas.py:204"),
        "tsm_conv1x1": ("csrc/tsm_conv.cu", "tsm_conv_pallas.py:215"),
        "normalize_frames": ("csrc/frame_ops.cu", "preprocess.py:53"),
        "temporal_shift": ("csrc/frame_ops.cu", "temporal_shift.py:98")}
    # each kernel's launches in the run of its path: window scoring under
    # pallas, training under pallas, scoring under auto (one normalize a
    # vision call) and scoring with fuse_tsm=False
    runs_of = {"tsm_conv1x1_bn_relu": "score pallas",
               "tsm_conv1x1": "train pallas",
               "normalize_frames": "score auto",
               "temporal_shift": "score fuse_tsm=False"}
    out = []
    for name, e in entries.items():
        src, replaces = sources[name]
        b_ms, b_by = bound(e["flops"], e["bytes"])
        n = seen[runs_of[name]][name]
        out.append({"name": name, "route": "cuda",
                    "source": f"video_chapter_generation_tpu_torch/{src}",
                    "replaces": f"video_chapter_generation_tpu/ops/{replaces}",
                    "launches": n, "max_abs_err": e["max_abs"],
                    "ms": e["ms"], "plain_ms": e["plain_ms"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": (e["library_ms"] if name != "temporal_shift"
                                   else None)})
    return out, {"argv": runs["auto"][1], "vocab": str(vocab)}


def int8_s2_phases(dev, smi, frames, vision, cli_argv):
    """K14a and K14b against their plain versions, the W8A8 vision call
    with INT8_S2_BLOCKS on, then cli/infer_video --int8_vision with it on.
    Returns the kernels' JSON entries."""
    import os

    import numpy as np
    import torch

    import video_chapter_generation_tpu_torch.models.resnet as port_resnet
    from video_chapter_generation_tpu_torch.cli import infer_video
    from video_chapter_generation_tpu_torch.models.resnet import _hwio
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.quantize import (
        calibrate_resnet_quant,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        bn_relu_maxpool,
        stem_frames,
        stem_int8,
        stem_int8_weights,
        stem_s2d,
        stem_s2d_int8,
        stem_s2d_int8_plain,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        int8_bottleneck,
        int8_s2_bottleneck,
        int8_s2_bottleneck_plain,
        tsm_bottleneck_int8,
        tsm_bottleneck_s2_planar_int8,
    )

    bf = torch.bfloat16
    entries = {k: {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0,
                   "max_abs": 0.0}
               for k in ("tsm_bottleneck_s2_planar_int8", "stem_s2d_int8")}
    stem_p, block_ps = vision.folded_params()
    n, hs = frames.shape[0], frames.shape[1]

    # --- K14b: the weight-only int8 stem at the serving stem shape: one
    # launch a call, no pool launch, two runs bit for bit ---
    sw = stem_int8_weights(_hwio(vision.conv1, torch.float32), stem_p["s"],
                           stem_p["b"])
    pools, before = bn_relu_maxpool.launches, stem_s2d_int8.launches
    y8 = stem_int8(frames, sw)
    torch.cuda.synchronize()
    if stem_s2d_int8.launches != before + 1:
        fail(f"stem_int8 made {stem_s2d_int8.launches - before} launches")
    if not torch.equal(y8, stem_int8(frames, sw)):
        fail("two runs of the int8 stem differ")
    y8 = hold(entries, "stem_s2d_int8", f"{tuple(frames.shape)} u8",
              lambda: stem_int8(frames, sw),
              lambda: stem_s2d_int8_plain(frames, *sw),
              # the stem's own ops, as K1 counts them (not the zeros
              # that the phase packing adds to the [432, 256] weight)
              2 * n * 4 * hs * hs * 147 * 64,
              frames.numel() + 432 * 256 + 4 * 10 * 256
              + n * hs * hs * 64 * 2, exact=True)
    y16 = stem_s2d(frames, stem_p["w7"], stem_p["s"], stem_p["b"])
    _, mean_rel, cos = compare(y8, y16)
    k1_ms = cuda_ms(lambda: stem_s2d(frames, stem_p["w7"], stem_p["s"],
                                     stem_p["b"]))
    if bn_relu_maxpool.launches != pools:
        fail("the int8 stem launched the pool kernel")
    print(f"# int8 stem vs the bf16 stem (K1) on the same frames: cosine "
          f"{cos:.6f} mean_rel {mean_rel:.3g} (the weight rounding); one "
          f"launch a call, two runs bit for bit, no pool launch; K14b "
          f"{entries['stem_s2d_int8']['ms']:.3f} ms, K1 {k1_ms:.3f} ms on "
          f"{smi}", flush=True)
    del y8, y16

    old = port_resnet.INT8_S2_BLOCKS
    port_resnet.INT8_S2_BLOCKS = True
    try:
        # --- K14a: the W8A8 trunk block by block, each fed the last ---
        t0 = time.time()
        vq = vision.quantized(calibrate_resnet_quant(vision, frames))
        torch.cuda.synchronize()
        print(f"# calibrated the s2d serving trunk on {n} frames in "
              f"{time.time() - t0:.2f} s", flush=True)
        plan = vq._quant_plan(None, (hs, hs))
        if plan.count("s2") != 3 or sum(1 for m in plan if m and m != "s2") \
                != 10:
            fail(f"INT8_S2_BLOCKS plan {plan}")
        qps = vq.quant_params(plan)
        y = stem_s2d(frames, stem_p["w7"], stem_p["s"], stem_p["b"])
        yb, k4_ms = y, 0.0  # the bf16 chain beside, for K4's yardstick
        for i, (blk, p) in enumerate(zip(vision.blocks(), block_ps)):
            mode = plan[i]
            if mode == "s2":  # K4 on the same block0 (its float weights)
                k4_ms += cuda_ms(lambda yb=yb, blk=blk, p=p: blk.run(
                    yb, p, CLIP_FRAMES, 8))
            yb = blk.run(yb, p, CLIP_FRAMES, 8)
            if mode is None:
                y = blk.run(y, p, CLIP_FRAMES, 8)
            elif mode != "s2":
                y = int8_bottleneck(y, qps[i], CLIP_FRAMES, 8, mode, bf)
            else:
                q = qps[i]
                nt, h, w, c = y.shape
                f, co = q.f, q.w3q.shape[1]
                m, mo = nt * h * w, nt * h * w // 4
                xb = y
                # the bf16 output mode on the same input, in the bf16 bands
                got = int8_s2_bottleneck(xb, q, CLIP_FRAMES, 8, "bf16")
                ref = int8_s2_bottleneck_plain(xb, q, CLIP_FRAMES, 8)[0]
                max_abs, mean_rel, cos = compare(got, ref.to(bf))
                print(f"# tsm_bottleneck_s2_planar_int8 block {i:2d} -> bf16: "
                      f"max_abs {max_abs:.4g} mean_rel {mean_rel:.3g} cos "
                      f"{cos:.6f} bitwise {torch.equal(got, ref.to(bf))}",
                      flush=True)
                if not (cos >= KERNEL_MIN_COS
                        and mean_rel <= KERNEL_MAX_MEAN_REL):
                    fail(f"K14a block {i} bf16 out disagrees with its plain "
                         f"version")
                del got, ref
                y = hold(
                    entries, "tsm_bottleneck_s2_planar_int8",
                    f"block {i:2d} {tuple(xb.shape)} {str(xb.dtype)[6:]} "
                    f"-> i8 F={f}",
                    lambda xb=xb, q=q: int8_s2_bottleneck(xb, q, CLIP_FRAMES,
                                                          8, "i8"),
                    lambda xb=xb, q=q: int8_s2_bottleneck_plain(
                        xb, q, CLIP_FRAMES, 8)[1],
                    2 * (m * c * f + mo * (9 * f * f + f * co + c * co)),
                    xb.numel() * xb.element_size()
                    + (c * f + 9 * f * f + f * co + c * co) + mo * co,
                    exact_int=True)
        print(f"# K14a on {plan.count('s2')} block0s: "
              f"{entries['tsm_bottleneck_s2_planar_int8']['ms']:.3f} ms; K4 "
              f"on the same blocks {k4_ms:.3f} ms on {smi}", flush=True)
        del y, yb

        # --- the W8A8 vision call with the switch, counted ---
        counted = (stem_s2d, tsm_bottleneck, tsm_bottleneck_s2,
                   tsm_bottleneck_int8, tsm_bottleneck_s2_planar_int8)
        for fn in counted:
            fn.launches = 0
        f_int8 = vq(frames).float()
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        want = {"stem_s2d": 1, "tsm_bottleneck": 3, "tsm_bottleneck_s2": 0,
                "tsm_bottleneck_int8": 10,
                "tsm_bottleneck_s2_planar_int8": 3}
        f_bf16 = vision(frames).float()
        cos = torch.nn.functional.cosine_similarity(f_int8, f_bf16, dim=1)
        print(f"# W8A8 vision call with INT8_S2_BLOCKS, {n} frames: "
              f"launches {launches}; per-frame cosine to the bf16 kernel "
              f"trunk min {cos.min().item():.6f}", flush=True)
        if launches != want:
            fail(f"INT8_S2_BLOCKS vision call launches {launches} != {want}")
        if cos.min().item() < INT8_TRUNK_MIN_COS:
            fail("the INT8_S2_BLOCKS trunk disagrees with the bf16 trunk")
        s2_launches = launches["tsm_bottleneck_s2_planar_int8"]
        del f_int8, f_bf16, vq

        # --- cli/infer_video --int8_vision with the switch on ---
        counted = (normalize_frames, stem_frames, bn_relu_maxpool,
                   tsm_bottleneck, tsm_bottleneck_s2, tsm_bottleneck_int8,
                   tsm_bottleneck_s2_planar_int8)
        for fn in counted:
            fn.launches = 0
        build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
        cwd = os.getcwd()
        os.chdir(build)  # the CLI writes test_results/ where it runs
        said = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(said):
                results = infer_video.main(cli_argv + ["--int8_vision",
                                                       "--pipelined"])
        finally:
            os.chdir(cwd)
            for line in said.getvalue().splitlines():
                print(f"# cli: {line}", flush=True)
        torch.cuda.synchronize()
    finally:
        port_resnet.INT8_S2_BLOCKS = old
    wall = time.time() - t0
    if "restored checkpoint at epoch 0" not in said.getvalue():
        fail("infer_video did not restore the checkpoint")
    launches = {fn.__name__: fn.launches for fn in counted}
    calls = sum(math.ceil(len(r.clip_scores) / SCORE_BATCH)
                for r in results.values())
    per_call = {"normalize_frames": 1, "stem_frames": 1,
                "bn_relu_maxpool": 0, "tsm_bottleneck": 3,
                "tsm_bottleneck_s2": 0, "tsm_bottleneck_int8": 10,
                "tsm_bottleneck_s2_planar_int8": 3}
    calib = {"normalize_frames": 1, "stem_frames": 1, "tsm_bottleneck": 13,
             "tsm_bottleneck_s2": 3}
    want = {k: v * calls + calib.get(k, 0) for k, v in per_call.items()}
    print(f"# infer_video --int8_vision --pipelined, INT8_S2_BLOCKS on: "
          f"{len(results)} videos, {calls} vision calls (+1 calibration "
          f"call), launches {launches}, {wall:.1f} s on {smi}", flush=True)
    if launches != want:
        fail(f"infer_video INT8_S2_BLOCKS launch counts {launches} != {want}")
    for vid, r in results.items():
        scores = np.asarray(r.clip_scores, np.float64)
        print(f"# {vid}: {len(scores)} clips, cut points {r.cut_points}, "
              f"{len(r.titles)} titles", flush=True)
        if not (np.isfinite(scores).all() and (scores >= 0).all()
                and (scores <= 1).all()):
            fail(f"{vid}: clip scores outside [0, 1]")
        if not r.cut_points or len(r.titles) != len(r.spans):
            fail(f"{vid}: {len(r.cut_points)} cut points, "
                 f"{len(r.titles)} titles for {len(r.spans)} chapters")
    torch.cuda.empty_cache()

    sources = {"tsm_bottleneck_s2_planar_int8": (
        "csrc/tsm_bottleneck_int8.cu", "tsm_block_int8_pallas.py:344"),
        "stem_s2d_int8": ("csrc/stem_s2d.cu", "stem_pallas.py:372")}
    # K14a's launches from the counted vision call; K14b is an op that no
    # model path runs (as in the JAX package), so its path count is 0
    counts = {"tsm_bottleneck_s2_planar_int8": s2_launches,
              "stem_s2d_int8": 0}
    out = []
    for name, e in entries.items():
        src, replaces = sources[name]
        b_ms, b_by = bound(e["flops"], e["bytes"], PEAK_INT8_OPS)
        out.append({"name": name, "route": "cuda",
                    "source": f"video_chapter_generation_tpu_torch/{src}",
                    "replaces": f"video_chapter_generation_tpu/ops/{replaces}",
                    "launches": counts[name], "max_abs_err": e["max_abs"],
                    "ms": e["ms"], "plain_ms": e["plain_ms"],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return out


def wide_phases(dev, smi, vision):
    """The stems on frames wider than 256 px, which their walk takes in
    column chunks: K1, K8, K11 (both entries, forward and backward) and
    K14b against their plain versions at each of WIDE_PX, WIDE_FRAMES
    seeded random frames, the serving model's stem weights."""
    import torch

    from video_chapter_generation_tpu_torch.models.resnet import _hwio
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        stem_chunks,
        stem_frames,
        stem_frames_reference,
        stem_int8,
        stem_int8_weights,
        stem_s2d,
        stem_s2d_int8,
        stem_s2d_int8_plain,
        stem_s2d_reference,
    )
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_frames_train,
        stem_s2d_train,
        stem_train_reference,
    )

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    stem_p, _ = vision.folded_params()
    sargs = (stem_p["w7"], stem_p["s"], stem_p["b"])
    sw = stem_int8_weights(_hwio(vision.conv1, torch.float32), stem_p["s"],
                           stem_p["b"])
    train_w = [vision.conv1.weight.permute(2, 3, 1, 0).float(),
               vision.bn1.weight.float(), vision.bn1.bias.float()]

    def held(label, pairs, grads=False):
        min_cos, max_rel = ((GRAD_MIN_COS, GRAD_MAX_MEAN_REL) if grads else
                            (KERNEL_MIN_COS, KERNEL_MAX_MEAN_REL))
        worst = (0.0, 0.0, 1.0)
        for got, ref in pairs:
            max_abs, mean_rel, cos = compare(got, ref)
            if not (cos >= min_cos and mean_rel <= max_rel):
                fail(f"{label} disagrees with its plain version: max_abs "
                     f"{max_abs:.4g} mean_rel {mean_rel:.3g} cos {cos:.6f}")
            worst = (max(worst[0], max_abs), max(worst[1], mean_rel),
                     min(worst[2], cos))
        return (f"max_abs {worst[0]:.4g} mean_rel {worst[1]:.3g} cos "
                f"{worst[2]:.6f}")

    def grads(fn, x, dy):
        ps = [p.detach().clone().requires_grad_() for p in train_w]
        y, stats = fn(x, *ps)
        return y, stats, torch.autograd.grad(y, ps, dy)

    for px in WIDE_PX:
        hs = px // 4
        s4 = torch.randint(0, 256, (WIDE_FRAMES, hs, hs, 48), generator=gen,
                           device=dev, dtype=torch.uint8)
        frames = normalize_frames(depth_to_space4(s4), bf)
        label = f"{tuple(s4.shape)} ({px} px, {stem_chunks(hs)} chunks)"
        note = held(f"stem_s2d {label}", [(stem_s2d(s4, *sargs),
                                           stem_s2d_reference(s4, *sargs))])
        print(f"# {'stem_s2d':18s} {label:44s} {note}", flush=True)
        note = held(f"stem_frames {label}",
                    [(stem_frames(frames, *sargs),
                      stem_frames_reference(frames, *sargs))])
        print(f"# {'stem_frames':18s} {label:44s} {note}", flush=True)
        dy = torch.randn(WIDE_FRAMES, hs, hs, 64, generator=gen,
                         device=dev).to(bf)
        ref = grads(lambda x, *ps: stem_train_reference(x, *ps), frames, dy)
        for name, fn, x in (("stem_s2d_train", stem_s2d_train, s4),
                            ("stem_frames_train", stem_frames_train,
                             frames)):
            y, (mu, var), g = grads(fn, x, dy)
            out = held(f"{name} {label}", [(y, ref[0]), (mu, ref[1][0]),
                                           (var, ref[1][1])])
            grad = held(f"{name} {label} gradients", list(zip(g, ref[2])),
                        True)
            print(f"# {name:18s} {label:44s} out/stats {out} | grads "
                  f"{grad}", flush=True)
        before = stem_s2d_int8.launches
        y8 = stem_int8(s4, sw)
        torch.cuda.synchronize()
        if stem_s2d_int8.launches != before + 1:
            fail(f"stem_int8 at {px} px made "
                 f"{stem_s2d_int8.launches - before} launches")
        if not torch.equal(y8, stem_s2d_int8_plain(s4, *sw)):
            fail(f"stem_s2d_int8 at {px} px is not its plain version bit "
                 f"for bit")
        if not torch.equal(y8, stem_int8(s4, sw)):
            fail(f"two runs of the int8 stem at {px} px differ")
        print(f"# {'stem_s2d_int8':18s} {label:44s} bitwise True, one "
              f"launch, two runs bit for bit on {smi}", flush=True)
    torch.cuda.empty_cache()


def chain_phases(dev, smi, frames, vision):
    """K15 against its plain version and the per-block K2/K3 sequence at
    the four stage chains of a 256-frame vision call, through both entries,
    then the vision call with chain_blocks=True. Returns the kernel's JSON
    entry."""
    import torch

    from video_chapter_generation_tpu_torch.ops.stem import stem_s2d
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_chain,
        tsm_bottleneck_chain_plain,
        tsm_bottleneck_halo_chain,
        tsm_bottleneck_s2,
    )

    e = {"ms": 0.0, "plain_ms": 0.0, "seq_ms": 0.0, "library_ms": 0.0,
         "work": [], "max_abs": 0.0}
    stem_p, block_ps = vision.folded_params()
    y = stem_s2d(frames, stem_p["w7"], stem_p["s"], stem_p["b"])
    start = 0
    for stage, n in enumerate(vision.stage_sizes):
        layer = list(getattr(vision, f"layer{stage + 1}"))
        y = layer[0].run(y, block_ps[start], CLIP_FRAMES, 8)
        blocks = [layer[k].chain_params(block_ps[start + k])
                  for k in range(1, n)]
        x = y

        def sequence(x=x, blocks=blocks, inputs=None):
            for blk in blocks:
                if inputs is not None:
                    inputs.append(x)
                x = tsm_bottleneck(x, *blk, CLIP_FRAMES)
            return x

        got = tsm_bottleneck_chain(x, blocks, CLIP_FRAMES)
        # the pair-merged output where the width is even (not layer4's 7)
        halo = tsm_bottleneck_halo_chain(x, blocks, CLIP_FRAMES,
                                         planar_out=x.shape[2] % 2 == 0)
        ref = tsm_bottleneck_chain_plain(x, blocks, CLIP_FRAMES)
        inputs = []
        seq = sequence(inputs=inputs)
        torch.cuda.synchronize()
        max_abs, mean_rel, cos = compare(got, ref)
        same_seq = torch.equal(got, seq)
        same_halo = torch.equal(halo, got.view(halo.shape))
        k_ms = cuda_ms(lambda x=x, blocks=blocks: tsm_bottleneck_chain(
            x, blocks, CLIP_FRAMES))
        s_ms = cuda_ms(sequence)
        p_ms = cuda_ms(lambda x=x, blocks=blocks: tsm_bottleneck_chain_plain(
            x, blocks, CLIP_FRAMES))
        # the library yardstick: each block's cuDNN sequence on its input
        libs = [library_block(xi, *blk, None, None, None, 1, CLIP_FRAMES)
                for xi, blk in zip(inputs, blocks)]
        l_ms = cuda_ms(lambda libs=libs: [run() for run in libs])
        del libs, inputs
        nt, h, w, c = x.shape
        f = blocks[0][0].shape[1]
        e["ms"] += k_ms
        e["seq_ms"] += s_ms
        e["plain_ms"] += p_ms
        e["library_ms"] += l_ms
        # per block: its products and weights; the chain's input read by
        # the first, its output written by the last
        flops = block_work(nt, h, w, c, f, c, 1, False)[0]
        for k in range(len(blocks)):
            e["work"].append((flops, 2 * (2 * c * f + 9 * f * f)
                              + (x.numel() * 2 if k == 0 else 0)
                              + (x.numel() * 2 if k == len(blocks) - 1
                                 else 0)))
        e["max_abs"] = max(e["max_abs"], max_abs)
        print(f"# tsm_bottleneck_chain layer{stage + 1} blocks 1-{n - 1} "
              f"{tuple(x.shape)} F={f}: vs plain max_abs {max_abs:.4g} "
              f"mean_rel {mean_rel:.3g} cos {cos:.6f}; bit for bit the "
              f"per-block K2/K3 sequence {same_seq}, halo entry {same_halo} "
              f"| chain {k_ms:.3f} ms, K2/K3 sequence {s_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, library {l_ms:.3f} ms", flush=True)
        if not (same_seq and same_halo and cos >= KERNEL_MIN_COS
                and mean_rel <= KERNEL_MAX_MEAN_REL):
            fail(f"tsm_bottleneck_chain at layer{stage + 1} disagrees")
        y = got
        start += n
    del x, y, got, halo, ref, seq

    counted = (stem_s2d, tsm_bottleneck, tsm_bottleneck_s2,
               tsm_bottleneck_chain)
    unchained = vision(frames)
    for fn in counted:
        fn.launches = 0
    vision.chain_blocks = True
    try:
        feats = vision(frames)
        torch.cuda.synchronize()
    finally:
        vision.chain_blocks = False
    launches = {fn.__name__: fn.launches for fn in counted}
    want = {"stem_s2d": 1, "tsm_bottleneck": 1, "tsm_bottleneck_s2": 3,
            "tsm_bottleneck_chain": 4}
    same = torch.equal(feats, unchained)
    print(f"# bf16 vision call with chain_blocks=True, {frames.shape[0]} "
          f"frames: launches {launches}; features equal to "
          f"chain_blocks=False: {same}; chains {e['ms']:.3f} ms against "
          f"{e['seq_ms']:.3f} ms for the per-block K2/K3 launches on {smi}",
          flush=True)
    if launches != want:
        fail(f"chain_blocks vision call launches {launches} != {want}")
    if not same:
        fail("chain_blocks=True changes the features")
    b_ms, b_by = bound_sum(e["work"])
    return {"name": "tsm_bottleneck_chain", "route": "cuda",
            "source": "video_chapter_generation_tpu_torch/csrc/tsm_chain.cu",
            "replaces": "video_chapter_generation_tpu/ops/"
                        "tsm_block_pallas.py:868",
            "launches": launches["tsm_bottleneck_chain"],
            "max_abs_err": e["max_abs"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": e["library_ms"]}


def vision_titles_phase(dev, smi, cli_argv, serving, int8_entry):
    """The extraction entry point and vision-conditioned beam titles:
    cli/extract_vision_emb at 224 px over the inference corpus's 16-frame
    clips in bf16 (s2d stem: K1, K2/K3, K4 launches counted exactly) and
    with --int8 (K9 too, plus the calibration call), the embeddings held
    to the float32 plain trunk on the CPU (one clip) and the int8 ones to
    the bf16 ones; then cli/infer_video --vision_emb_dir --fusion_type
    cross_attn --num_beams 4 --pipelined (Pegasus-large) from the
    checkpoint of the inference phase, a title per chapter; on the title
    inputs of its first call, one beam equal to greedy bit for bit and
    each beam-4 score equal to the teacher-forced, length-normalised
    log-prob of its ids, and beam-4 against greedy ms a step. Returns the
    extraction paths' kernel entries: the serving and inference entries'
    times (the same shapes: 256-frame calls at 224 px), this phase's
    launches."""
    import os

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import (
        eval_title,
        extract_vision_emb,
        infer_video,
    )
    from video_chapter_generation_tpu_torch.cli.common import (
        load_corpus,
        parse_config,
    )
    from video_chapter_generation_tpu_torch.core.metrics import StepTimer
    from video_chapter_generation_tpu_torch.data.clip_grid import (
        flatten_video_to_clips,
    )
    from video_chapter_generation_tpu_torch.data.frames import (
        load_clip_frames,
    )
    from video_chapter_generation_tpu_torch.models.resnet import Resnet50TSM
    from video_chapter_generation_tpu_torch.models.seq2seq import (
        beam_search,
        generate,
    )
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        stem_frames,
        stem_s2d,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        tsm_bottleneck_int8,
    )

    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    cfg, _ = parse_config(cli_argv)
    corpus = load_corpus(cfg, "test")
    clips = [c.to_json() for vid in corpus.vids
             for c in flatten_video_to_clips(
                 vid, corpus.img_dir, corpus.image_num(vid),
                 corpus.raw_cut_secs(vid), corpus.subtitles(vid),
                 CLIP_FRAMES)]
    clips_json = build / "vision_clips.json"
    clips_json.write_text(json.dumps(clips))
    counted = (normalize_frames, stem_frames, stem_s2d, tsm_bottleneck,
               tsm_bottleneck_s2, tsm_bottleneck_int8)
    calls = math.ceil(len(clips) / SCORE_BATCH)

    def run(name, fn, want_of):
        """fn() with every count at 0 just before and read just after,
        its stdout kept; the counts must equal want_of(fn's result)
        (absent names: 0). Returns (fn's result, its stdout)."""
        for k in counted:
            k.launches = 0
        said = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(said):
                out = fn()
        finally:
            for line in said.getvalue().splitlines():
                print(f"# {name}: {line}", flush=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k.__name__: k.launches for k in counted}
        want = {k.__name__: want_of(out).get(k.__name__, 0) for k in counted}
        print(f"# {name}: launches {launches} in {wall:.1f} s on {smi}",
              flush=True)
        if launches != want:
            fail(f"{name} launch counts {launches} != {want}")
        return out, said.getvalue(), launches

    # --- extraction, bf16 then W8A8 (a bf16 calibration call first) ---
    ext_argv = [f"data.test_clips_json={clips_json}",
                f"data.clip_frame_num={CLIP_FRAMES}",
                f"data.batch_size={SCORE_BATCH}"]
    wants = {"bf16": {"stem_s2d": calls, "tsm_bottleneck": 13 * calls,
                      "tsm_bottleneck_s2": 3 * calls},
             "int8": {"stem_s2d": calls + 1,
                      "tsm_bottleneck": 3 * calls + 13,
                      "tsm_bottleneck_s2": 3 * calls + 3,
                      "tsm_bottleneck_int8": 10 * calls}}
    ext_launches, dirs = {}, {}
    for mode, flags in (("bf16", []), ("int8", ["--int8"])):
        out_dir = dirs[mode] = build / f"vision_embs_{mode}"
        for old in out_dir.glob("*/*.npy"):
            old.unlink()
        timer = StepTimer()
        n, _, ext_launches[mode] = run(
            f"extract_vision_emb {mode}",
            lambda flags=flags, out_dir=out_dir, timer=timer:
                extract_vision_emb.main(
                    ext_argv + ["--out_dir", str(out_dir)] + flags,
                    timer=timer),
            lambda _, mode=mode: wants[mode])
        if n != len(clips):
            fail(f"extract_vision_emb {mode} wrote {n} of {len(clips)}")
        emb = timer.summary()["embed"]
        print(f"# extract_vision_emb {mode} at 224 px: {n} clips x "
              f"{CLIP_FRAMES} frames in {calls} calls of up to {SCORE_BATCH} "
              f"clips: {emb['items_per_sec']:.1f} frames/s over all calls "
              f"(the embed stage: the device call and the copy back, "
              f"{emb['seconds']:.3f} s) on {smi}; information only, not a "
              f"benchmark", flush=True)

    def load(mode, clip):
        s, t = clip["clip_start_end"]
        return np.load(dirs[mode] / clip["vid"] / f"vision_emb_{s}_{t}.npy")

    embs = {mode: np.stack([load(mode, c) for c in clips]) for mode in dirs}
    for mode, e in embs.items():
        if e.shape != (len(clips), CLIP_FRAMES, 2048) or e.dtype != \
                np.float32 or not np.isfinite(e).all():
            fail(f"{mode} embeddings {e.shape} {e.dtype}, or not finite")
    # the first clip against the float32 plain trunk on the CPU
    ref = Resnet50TSM(CLIP_FRAMES, stem_input="s2d").eval()
    ref.base_model.load_state_dict(extract_vision_emb.init_weights(ref))
    want = ref(torch.from_numpy(load_clip_frames(
        clips[0]["image_paths"], 224, s2d=True))[None])[0]

    def cos_min(a, b):
        return torch.nn.functional.cosine_similarity(
            torch.as_tensor(a).double().reshape(-1, 2048),
            torch.as_tensor(b).double().reshape(-1, 2048), dim=1).min().item()

    c_ref = cos_min(embs["bf16"][0], want)
    c_int8 = cos_min(embs["int8"], embs["bf16"])
    print(f"# extraction embeddings: bf16 kernels vs the float32 plain "
          f"trunk on the CPU, first clip, per-frame cosine min {c_ref:.6f}; "
          f"int8 vs bf16, all {len(clips)} clips, per-frame cosine min "
          f"{c_int8:.6f}", flush=True)
    if c_ref < TRUNK_MIN_COS:
        fail("the extraction trunk disagrees with its float32 plain version")
    if c_int8 < INT8_TRUNK_MIN_COS:
        fail("the W8A8 extraction trunk disagrees with the bf16 one")
    del ref, embs

    # --- infer_video with vision-conditioned beam-4 titles ---
    def vision_calls(results):  # the boundary model's frames-stem trunk
        n = sum(math.ceil(len(r.clip_scores) / SCORE_BATCH)
                for r in results.values())
        return {"normalize_frames": n, "stem_frames": n,
                "tsm_bottleneck": 13 * n, "tsm_bottleneck_s2": 3 * n}

    cwd = os.getcwd()
    os.chdir(build)  # the CLI writes test_results/ where it runs
    try:  # the title decode's first beam search keeps its inputs
        with first_calls({(eval_title, "beam_search"): 1}) as kept:
            results, said, _ = run(
                "infer_video vision titles",
                lambda: infer_video.main(cli_argv + [
                    "--vision_emb_dir", str(dirs["bf16"]), "--fusion_type",
                    "cross_attn", "--num_beams", str(BEAMS), "--pipelined"]),
                vision_calls)
    finally:
        os.chdir(cwd)
    if "restored checkpoint at epoch 0" not in said:
        fail("infer_video did not restore the boundary checkpoint")
    for vid, r in results.items():
        print(f"# {vid}: cut points {r.cut_points}, {len(r.titles)} beam-"
              f"{BEAMS} vision titles for {len(r.spans)} chapters", flush=True)
        if not r.cut_points or len(r.titles) != len(r.spans):
            fail(f"{vid}: {len(r.titles)} titles for {len(r.spans)} "
                 f"chapters")
    if len(results) != INFER_VIDEOS or not kept["beam_search"]:
        fail(f"infer_video chaptered {len(results)} videos")
    stages = json.loads(said.split("stage seconds: ")[1].splitlines()[0])
    steps = sum(1 for r in results.values() if r.spans) * TITLE_OUT
    print(f"# beam-{BEAMS} vision title decode in the CLI (Pegasus-large, "
          f"bf16, fused encode included, batch = one video's chapters): "
          f"{1e3 * stages['title_generate']['seconds'] / steps:.2f} ms per "
          f"step over {steps} steps on {smi}", flush=True)

    # --- the title path on the CLI's first title inputs, on the card ---
    (s2s, ids, mask), kw = kept.pop("beam_search")[0]
    enc, max_len, lp = kw["enc_hidden"], kw["max_len"], 1.0
    greedy = generate(s2s, ids, mask, max_len=max_len, enc_hidden=enc)
    one = beam_search(s2s, ids, mask, num_beams=1, max_len=max_len,
                      enc_hidden=enc)[0]
    if not torch.equal(one, greedy):
        fail("num_beams=1 ids differ from greedy ids on the card")
    beam_ids, scores = beam_search(s2s, ids, mask, num_beams=BEAMS,
                                   max_len=max_len, enc_hidden=enc)
    eos = s2s.cfg.eos_token_id

    def forced(rep):
        """Teacher-forced, length-normalised log-prob of beam_ids, each row
        fed `rep` times (rep = BEAMS: the batch layout of the search)."""
        b = ids.shape[0]
        tgt = beam_ids.repeat_interleave(rep, 0)
        e, m = enc.repeat_interleave(rep, 0), mask.repeat_interleave(rep, 0)
        cache = s2s.init_cache(b * rep, max_len, e)
        tok = torch.full((b * rep, 1), s2s.cfg.decoder_start_token_id,
                         dtype=torch.long, device=dev)
        total = torch.zeros(b * rep, dtype=torch.float32, device=dev)
        length = torch.full((b * rep,), float(max_len), device=dev)
        live = torch.ones(b * rep, dtype=torch.bool, device=dev)
        for pos in range(max_len):
            logits, cache = s2s.decode_step(tok, pos, cache, m, max_len)
            logp = torch.log_softmax(logits.float(), dim=-1)
            total += torch.where(live, logp.gather(1, tgt[:, pos:pos + 1])[
                :, 0], 0.0)
            ended = live & (tgt[:, pos] == eos)
            length = torch.where(ended, float(pos + 1), length)
            live = live & ~ended
            tok = tgt[:, pos:pos + 1]
        return (total / length ** lp)[::rep]

    gap = (forced(BEAMS) - scores).abs().max().item()
    gap_b = (forced(1) - scores).abs().max().item()
    print(f"# beam-{BEAMS} scores vs the teacher-forced, length-normalised "
          f"log-prob of their ids ({ids.shape[0]} rows, scores "
          f"{[round(x, 4) for x in scores.tolist()]}): max gap {gap:.3g} in "
          f"the search's batch layout, {gap_b:.3g} at batch "
          f"{ids.shape[0]}; num_beams=1 equals greedy bit for bit",
          flush=True)
    if not max(gap, gap_b) <= BEAM_SCORE_TOL:
        fail(f"beam scores differ from their teacher-forced log-probs by "
             f"{max(gap, gap_b):.3g}")

    def step_ms(fn, runs=3):
        fn()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[runs // 2] / max_len

    g_ms = step_ms(lambda: generate(s2s, ids, mask, max_len=max_len,
                                    enc_hidden=enc))
    b_ms = step_ms(lambda: beam_search(s2s, ids, mask, num_beams=BEAMS,
                                       max_len=max_len, enc_hidden=enc))
    print(f"# vision title decode, Pegasus-large bf16, batch "
          f"{ids.shape[0]}, encoder {ids.shape[1]}, {max_len} steps from the "
          f"fused states: greedy {g_ms:.3f} ms per step, beam-{BEAMS} "
          f"{b_ms:.3f} ms per step ({b_ms / g_ms:.2f}x; median of 3) on "
          f"{smi}", flush=True)
    del kept, s2s, enc
    torch.cuda.empty_cache()

    out = []
    for mode, launches in ext_launches.items():
        path = "extract_vision_emb" + (" --int8" if mode == "int8" else "")
        names = list(serving) + (["tsm_bottleneck_int8"] if mode == "int8"
                                 else [])
        for name in names:
            base = int8_entry if name == "tsm_bottleneck_int8" else \
                serving[name]
            out.append(dict(base, launches=launches[name], path=path))
    return out


def native_decode_phase(dev, smi, pipe, corpus):
    """The native host decoder (data/native_loader.py, native/vcg_host.cc
    built with g++ and libjpeg), where the machine has both (checked
    before any build; where it lacks them, a line says so and the phase
    runs nothing): its s2d decode of one video's frames bit for bit
    equal to PIL plus the numpy s2d pack, frames/s of both, and
    ChapterPipeline over the same video with it installed giving clip
    scores and cut points bit for bit equal to the PIL run's, with the
    exact K1-K4 launch counts. Returns those launches, or None."""
    import numpy as np

    from video_chapter_generation_tpu_torch.data import (
        frames as host_frames,
        native_loader,
    )
    from video_chapter_generation_tpu_torch.ops.stem import stem_s2d
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )

    ok, why = native_loader.toolchain()
    if not ok:
        print(f"# native_decode: not run: {why} on this machine (nothing "
              f"can be installed there); the pipeline decodes with PIL",
              flush=True)
        return None
    t0 = time.time()
    lib = native_loader.build_library()
    print(f"# native_decode: {lib.name} built with {why} in "
          f"{time.time() - t0:.1f} s", flush=True)
    vid = corpus.vids[0]
    paths = [corpus.frame_path(vid, i)
             for i in range(1, corpus.image_num(vid) + 1)]
    loader = native_loader.NativeLoader(8)
    rates = {}
    for name, decode in (
            ("PIL + numpy s2d", lambda: host_frames.load_clip_frames(
                paths, 224, s2d=True)),
            ("native s2d", lambda: loader.decode_batch_s2d(paths, 224))):
        t0 = time.time()
        out = decode()
        rates[name] = (len(paths) / (time.time() - t0), out)
    (pil_rate, pil), (nat_rate, nat) = rates.values()
    if loader.failures or not np.array_equal(pil, nat):
        fail(f"the native s2d decode differs from PIL's on {vid} "
             f"({loader.failures} failed decodes)")
    print(f"# native_decode: {len(paths)} frames of {vid} at 224 px, the "
          f"s2d pack bit for bit PIL's; PIL + numpy s2d "
          f"{pil_rate:.1f} frames/s, native s2d (8 threads) "
          f"{nat_rate:.1f} frames/s on {smi}; information only", flush=True)

    counted = (stem_s2d, tsm_bottleneck, tsm_bottleneck_s2)
    ref = pipe.run([vid])[vid]
    installed = native_loader.install_native_loader(8)
    for k in counted:
        k.launches = 0
    try:
        got = pipe.run([vid])[vid]
    finally:
        host_frames.set_native_loader(None)
    import torch

    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counted}
    calls = math.ceil(len(got.clip_scores) / SCORE_BATCH)
    want = {"stem_s2d": calls, "tsm_bottleneck": 13 * calls,
            "tsm_bottleneck_s2": 3 * calls}
    print(f"# native_decode: ChapterPipeline on {vid} with the native "
          f"decoder: {len(got.clip_scores)} clips, cut points "
          f"{got.cut_points}, launches {launches}", flush=True)
    if installed.failures:
        fail(f"the pipeline's native decode failed on {installed.failures} "
             f"frames")
    if launches != want:
        fail(f"native_decode launch counts {launches} != {want}")
    if not (np.array_equal(np.asarray(got.clip_scores),
                           np.asarray(ref.clip_scores))
            and got.cut_points == ref.cut_points):
        fail("the pipeline's scores or cut points differ between the "
             "native and the PIL decoder")
    return launches


def title_training_phase(dev, smi, cli_argv, emb_dir, k10_entry):
    """Title training through cli/train_title.main: Pegasus-large at the
    JAX CLI's defaults (bf16, batch 16, 512 -> 30 tokens) on a synthetic
    corpus for TITLE_EPOCHS x TITLE_STEPS optimizer steps and the eval, with finite
    losses, moved parameters and a checkpoint; gradient accumulation (2
    micro-batches) against one update over both, and remat against none;
    cli/infer_video restoring that checkpoint beside the inference
    phase's boundary checkpoint and titling from it; then the
    vision-conditioned model over the vision_titles phase's embeddings,
    BigBird at 3072 tokens (K10: no launch in a training step, 16 a batch
    in the eval) and BART, 2 steps each, their checkpoints not written.
    Prints ms a step, tokens/s and peak memory of each run. Returns K10's
    entry for the BigBird eval, held and timed on that eval's inputs."""
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import (
        infer_video,
        train_title,
    )
    from video_chapter_generation_tpu_torch.cli.common import parse_config
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
    from video_chapter_generation_tpu_torch.data.loader import collate
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.data.tokenization import (
        UnigramTokenizer,
    )
    from video_chapter_generation_tpu_torch.models import (
        sparse_attention as sparse_model,
    )
    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
    )
    from video_chapter_generation_tpu_torch.train.loop import Trainer
    from video_chapter_generation_tpu_torch.train.optim import make_optimizer

    t_phase = time.time()
    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    n_train = TITLE_BATCH * TITLE_STEPS
    paths = make_synth_corpus_on_disk(
        str(build / "synth_title_corpus"), n_videos=n_train + TITLE_BATCH,
        video_sec=96, hw=32, seed=SEED + 11,
        splits={"train": n_train, "val": TITLE_BATCH})
    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["train_vid_file"],
                                    paths["subtitle_dir"])
    val_vids = open(paths["val_vid_file"]).read().split()
    small = {}
    for name, vids in (("train", corpus.vids[:4]), ("val", val_vids[:2])):
        small[name] = build / f"title_small_{name}.txt"
        small[name].write_text("\n".join(vids) + "\n")
    # the corpus's piece table, padded with pieces no text contains to
    # Pegasus-large's vocabulary: the embedding and the LM head at their
    # published size; train_title and infer_video read the same table
    tok = UnigramTokenizer.build_from_corpus(
        [s["text"] for vid in corpus.vids for s in corpus.subtitles(vid)],
        vocab_size=8000)
    pieces = dict(tok.pieces)
    specials = {tok.pad_token, tok.eos_token, tok.unk_token}
    low = min(pieces.values()) - 10.0
    n = len(specials) + len([q for q in pieces if q not in specials])
    pieces.update({f"<unused{i}>": low for i in range(PEGASUS_VOCAB - n)})
    tsv = build / "title_pieces.tsv"
    tsv.write_text("".join(f"{q}\t{v}\n" for q, v in pieces.items()))
    if UnigramTokenizer.from_tsv(str(tsv)).vocab_size != PEGASUS_VOCAB:
        fail("the padded piece table is not Pegasus-large's vocabulary")
    print(f"# title corpus ({n_train + TITLE_BATCH} videos) and piece table: "
          f"{time.time() - t_phase:.1f} s", flush=True)

    def argv_for(train_file, val_file, batch, *extra, img=paths["img_dir"],
                 data=paths["data_file"], subs=paths["subtitle_dir"]):
        return [f"data.img_dir={img}", f"data.data_file={data}",
                f"data.subtitle_dir={subs}",
                f"data.train_vid_file={train_file}",
                f"data.val_vid_file={val_file}",
                "model.compute_dtype=bfloat16", f"data.batch_size={batch}",
                f"data.title_input_len={TITLE_IN}",
                f"data.title_decode_len={TITLE_OUT}", "optim.lr_decay=false",
                "train.max_epochs=1", "train.eval_every_epochs=1",
                "train.resume=false", *extra, "--spm_tsv", str(tsv)]

    steps, snap = [], {}
    plain_step = Trainer.train_step

    def spy(self, batch):
        """Trainer.train_step, with its loss, its K10 launches and its
        wall time (synchronized) kept; the first keeps a few parameters and
        the time it starts at."""
        k10 = sparse_band_attention.launches
        torch.cuda.synchronize()
        t0 = time.time()
        if not steps:
            snap.update({k: p.detach().clone() for k, p in list(
                self.model.named_parameters())[::40]})
            snap["first step at"] = t0
        m = plain_step(self, batch)
        loss = float(m["loss"].detach())
        steps.append((loss, sparse_band_attention.launches - k10,
                      time.time() - t0))
        return m

    plain_save = CheckpointManager.save

    def train(name, argv, ckpt, want_steps, keep=False):
        """One train_title run. keep: the checkpoint is written (and kept
        for infer_video); otherwise the save is recorded, not written."""
        steps.clear()
        snap.clear()
        scores = []
        shutil.rmtree(ckpt, ignore_errors=True)
        sparse_band_attention.launches = 0
        sparse_band_attention.serving_launches = 0
        torch.cuda.reset_peak_memory_stats()
        said = io.StringIO()
        t0 = time.time()
        Trainer.train_step = spy
        if not keep:
            CheckpointManager.save = lambda self, epoch, state, score=None, \
                metrics=None: scores.append(score)
        try:
            with contextlib.redirect_stdout(said):
                trainer = train_title.main(argv + [
                    f"train.ckpt_dir={ckpt}", f"train.log_dir={ckpt}_logs",
                    "--device", str(dev)])
        finally:
            Trainer.train_step = plain_step
            CheckpointManager.save = plain_save
            for line in said.getvalue().splitlines():
                print(f"# {name}: {line}", flush=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        set_up = snap.pop("first step at", t0) - t0
        losses = [st[0] for st in steps]
        moved = sum(not torch.equal(v, dict(
            trainer.model.named_parameters())[k].detach())
            for k, v in snap.items())
        k10_train = sum(st[1] for st in steps)
        k10_eval = sparse_band_attention.launches - k10_train
        cfg = trainer.cfg
        step_s = float(np.median([st[2] for st in steps[1:] or steps]))
        tokens = cfg.data.batch_size * (cfg.data.title_input_len
                                        + cfg.data.title_decode_len)
        print(f"# {name}: {len(steps)} steps, losses "
              f"{[round(x, 4) for x in losses]}, {moved} of {len(snap)} "
              f"sampled parameters moved; {1e3 * step_s:.1f} ms a step "
              f"(median), {tokens / step_s:.0f} tokens/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K10 "
              f"launches: {k10_train} in training steps, {k10_eval} in the "
              f"eval ({sparse_band_attention.serving_launches} serving); "
              f"{wall:.1f} s in all, {set_up:.1f} s of it before the first "
              f"step (corpus, tokenizer, seeded model on the card)"
              f"{', with a checkpoint written' if keep else ''} on {smi}; "
              f"information only", flush=True)
        if len(steps) != want_steps or not np.isfinite(losses).all():
            fail(f"{name}: {len(steps)} steps, losses {losses}")
        if not moved:
            fail(f"{name}: no sampled parameter moved")
        if keep:
            ck = CheckpointManager(str(ckpt))
            scores = [ck.metrics_for(ck.latest_step()).get("score")
                      ] if ck.steps() else []
        if not scores or scores[-1] is None or not np.isfinite(scores[-1]):
            fail(f"{name}: no checkpoint saved with an eval score")
        return trainer, k10_train, k10_eval

    # --- Pegasus-large at the JAX CLI's defaults ---
    ckpt = build / "title_ckpt"
    trainer, _, _ = train(
        "train_title pegasus", argv_for(
            paths["train_vid_file"], paths["val_vid_file"], TITLE_BATCH,
            f"train.max_epochs={TITLE_EPOCHS}",
            f"train.eval_every_epochs={TITLE_EPOCHS}",
            f"train.save_every_epochs={TITLE_EPOCHS}"),
        ckpt, TITLE_EPOCHS * TITLE_STEPS, keep=True)
    model, task = trainer.model, trainer.task
    params = list(model.parameters())
    ds = trainer.train_loader.dataset
    items = [ds.__getitem__(i, 0) for i in range(len(ds))]

    # accumulation: A then B (float32, dropout off) vs A and B at once;
    # A and B pair rows of equal decoder length, so that the mean of the
    # two batch means is the mean over both
    by_len = {}
    for it in items:
        by_len.setdefault(int(it["decode_attention_mask"].sum()),
                          []).append(it)
    a_rows, b_rows = [], []
    for group in by_len.values():
        while len(group) >= 2 and len(a_rows) < ACCUM_ROWS:
            a_rows.append(group.pop())
            b_rows.append(group.pop())
    if len(a_rows) < ACCUM_ROWS:
        fail("too few rows of equal decoder length for the accumulation "
             "check")
    p0 = [p.detach().clone() for p in params]
    model.eval()  # no dropout; gradients still recorded
    task.dtype = torch.float32

    plain_clip = torch.nn.utils.clip_grad_norm_

    def update(batches, k):
        """One optimizer update of the Trainer over batches as k
        micro-steps, from p0 and a fresh AdamW: (the gradient it clips,
        the parameters' change)."""
        with torch.no_grad():
            for p, q in zip(params, p0):
                p.copy_(q)
        trainer.cfg = trainer.cfg.replace(optim=dataclasses.replace(
            trainer.cfg.optim, gradient_accumulation_steps=k))
        trainer.opt = make_optimizer(trainer.cfg.optim, model, task.entries)
        trainer.step = 0
        grads = []

        def clip(*args, **kw):  # keeps the gradient the update is given
            grads[:] = [torch.zeros_like(p) if p.grad is None
                        else p.grad.detach().clone() for p in params]
            return plain_clip(*args, **kw)

        torch.nn.utils.clip_grad_norm_ = clip
        try:
            for b in batches:
                trainer.train_step(b)
        finally:
            torch.nn.utils.clip_grad_norm_ = plain_clip
        if trainer.step != k or not grads:
            fail("the accumulation cycle did not close")
        return grads, [(p.detach() - q) for p, q in zip(params, p0)]

    def cos_of(xs, ys):
        dot = sum((x.double() * y.double()).sum() for x, y in zip(xs, ys))
        return (dot / (sum((x.double() ** 2).sum() for x in xs).sqrt()
                       * sum((y.double() ** 2).sum() for y in ys).sqrt())
                ).item()

    g_acc, d_acc = update([collate(a_rows), collate(b_rows)], 2)
    g_one, d_one = update([collate(a_rows + b_rows)], 1)
    g_rel = (sum(((x.double() - y.double()) ** 2).sum()
                 for x, y in zip(g_acc, g_one)).sqrt()
             / sum((y.double() ** 2).sum() for y in g_one).sqrt()).item()
    c_acc = cos_of(d_acc, d_one)
    del g_acc, g_one, d_acc, d_one
    print(f"# title accumulation: gradient_accumulation_steps=2 over 2 x "
          f"{ACCUM_ROWS} rows vs one update over the {2 * ACCUM_ROWS} rows "
          f"(float32, dropout off): the updates' gradients (before the "
          f"clip) {g_rel:.3g} apart (relative norm); cosine of the "
          f"parameters' change {c_acc:.6f}", flush=True)
    if not (g_rel <= ACCUM_MAX_GRAD_REL and c_acc >= ACCUM_MIN_COS):
        fail(f"an accumulated update disagrees with one update over both "
             f"batches (gradients {g_rel:.3g} apart, cosine {c_acc:.6f})")

    # remat: one bf16 step each way on the same batch and dropout seed
    with torch.no_grad():
        for p, q in zip(params, p0):
            p.copy_(q)
    del p0
    model.train()
    task.dtype = torch.bfloat16
    batch = collate(items[:TITLE_BATCH])
    runs = {}
    for remat in (False, True):
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 12)
        loss, _ = task.loss_fn(model, batch, gen)
        loss.backward()
        torch.cuda.synchronize()
        runs[remat] = (loss.detach(), [p.grad.clone() for p in params],
                       torch.cuda.max_memory_allocated() / 2 ** 30)
    model.cfg = dataclasses.replace(model.cfg, remat=False)
    model.zero_grad(set_to_none=True)
    (l0, g0, m0), (l1, g1, m1) = runs[False], runs[True]
    c_remat = cos_of(g0, g1)
    print(f"# title remat: loss {l0.item():.6f} without, {l1.item():.6f} "
          f"with (equal: {torch.equal(l0, l1)}); gradients' cosine "
          f"{c_remat:.7f}; peak {m0:.2f} GiB without, {m1:.2f} GiB with "
          f"(batch {TITLE_BATCH}, bf16) on {smi}", flush=True)
    if not torch.equal(l0, l1) or not c_remat >= REMAT_MIN_COS:
        fail("a remat step disagrees with the step without remat")
    del runs, g0, g1

    # where a step's time goes (information only): the Trainer's step on
    # one batch outside the CLI's loop (no loader threads), timed, then one
    # torch.profiler trace; the model's arithmetic as 6 x parameters x
    # tokens (encoder layers over the input, decoder layers and the tied
    # head over the target; attention scores left out)
    trainer.opt = make_optimizer(trainer.cfg.optim, model, task.entries)
    trainer.train_step(batch)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    step_s = sorted(times)[1]
    n_enc = sum(q.numel() for q in model.model.encoder.parameters())
    n_dec = sum(q.numel() for q in model.model.decoder.parameters())
    n_head = model.model.shared.weight.numel()
    flops = 6 * TITLE_BATCH * (n_enc * TITLE_IN + (n_dec + n_head) * TITLE_OUT)
    trace = "trace: not measured"
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(batch)
            torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
        # kernels only: a named range (the optimizer's step) also shows a
        # device span, which would count its kernels twice
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "#" not in e.key
                and not e.key.startswith(("Optimizer.", "ProfilerStep"))]

        def dev_us(e):
            return (getattr(e, "self_device_time_total", 0)
                    or getattr(e, "self_cuda_time_total", 0))

        busy = sum(dev_us(e) for e in kern)
        opt_us = sum(dev_us(e) for e in kern
                     if "multi_tensor" in e.key or "foreach" in e.key.lower())
        top = sorted(kern, key=dev_us, reverse=True)[:4]
        if busy > 0:
            trace = (f"trace: {sum(e.count for e in kern)} kernels, device "
                     f"busy {busy / wall_us:.3f} of the traced wall time, "
                     f"multi-tensor (AdamW, clip) kernels "
                     f"{opt_us / busy:.3f} of the device time; largest: "
                     + ", ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.1f} ms"
                                 for e in top))
        else:
            trace = "trace: the profiler saw no device time"
    except Exception as exc:  # the trace is information only
        trace = f"trace: not measured ({type(exc).__name__})"
    print(f"# title training step, Pegasus-large bf16, batch {TITLE_BATCH}, "
          f"{TITLE_IN} -> {TITLE_OUT} tokens, outside the CLI's loader: "
          f"{1e3 * step_s:.1f} ms (median of 3), model arithmetic "
          f"{flops / 1e12:.2f} TFLOP a step, {flops / step_s / 1e12:.1f} "
          f"TFLOP/s; {trace}; on {smi}; information only", flush=True)
    print(f"# title_training: {time.time() - t_phase:.1f} s into the phase "
          f"after the Pegasus run and its checks", flush=True)
    del model, task, params, trainer, items
    torch.cuda.empty_cache()

    # --- infer_video from that checkpoint, beside the boundary one ---
    icfg = parse_config(cli_argv)[0]
    serve = build / "title_serving_ckpt"
    shutil.rmtree(serve, ignore_errors=True)
    serve.mkdir(parents=True)
    boundary = Path(icfg.train.ckpt_dir)
    title_src = ckpt / f"ckpt_{CheckpointManager(str(ckpt)).latest_step()}"
    for src, epoch in ((boundary / "ckpt_0", 0), (title_src, 1)):
        for ext in ("pt", "json"):
            os.symlink(f"{src}.{ext}", serve / f"ckpt_{epoch}.{ext}")
    cwd = os.getcwd()
    os.chdir(build)  # the CLI writes test_results/ where it runs
    said = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(said):
            results = infer_video.main(cli_argv + [
                f"train.ckpt_dir={serve}", "--spm_tsv", str(tsv)])
    finally:
        os.chdir(cwd)
        for line in said.getvalue().splitlines():
            print(f"# infer_video, trained titles: {line}", flush=True)
    out = said.getvalue()
    n_titles = sum(len(r.titles) for r in results.values())
    print(f"# infer_video from the trained title checkpoint: "
          f"{len(results)} videos, {n_titles} titles, "
          f"{time.time() - t0:.1f} s", flush=True)
    if "restored checkpoint at epoch 0" not in out or \
            "restored checkpoint at epoch 1" not in out:
        fail("infer_video did not restore the boundary and the title "
             "checkpoints")
    for vid, r in results.items():
        if not r.cut_points or len(r.titles) != len(r.spans):
            fail(f"{vid}: {len(r.titles)} titles for {len(r.spans)} "
                 f"chapters")
    shutil.rmtree(serve, ignore_errors=True)  # ckpt stays for evaluation
    torch.cuda.empty_cache()

    # --- vision-conditioned (the inference corpus, whose clips have
    # embeddings), BigBird at 3072 tokens, BART: 2 steps each ---
    d = icfg.data
    train("train_title vision", argv_for(
        d.test_vid_file, d.test_vid_file, SMALL_BATCH,
        f"model.vision_init={emb_dir}", "train.max_epochs=2",
        "train.eval_every_epochs=2", "train.save_every_epochs=2",
        img=d.img_dir, data=d.data_file, subs=d.subtitle_dir),
        build / "title_ckpt_vision", 2)
    torch.cuda.empty_cache()
    # the eval's first K10 call (encoder layer 0 of its one batch) keeps
    # its inputs, and K10 is held to its plain version on them below
    with first_calls({(sparse_model, "sparse_band_attention"): 1}) as kept:
        big, k10_train, k10_eval = train(
            "train_title bigbird", argv_for(
                small["train"], small["val"], SMALL_BATCH, "--title_arch",
                "bigbird", f"data.title_input_len={BIGBIRD_IN}"),
            build / "title_ckpt_bigbird", 2)
    s2s = big.model.cfg
    del big
    if k10_train or k10_eval != s2s.encoder_layers or \
            sparse_band_attention.serving_launches != k10_eval:
        fail(f"BigBird title training launched K10 {k10_train} times in "
             f"its steps and {k10_eval} in its one eval batch (want 0 and "
             f"{s2s.encoder_layers}, all on the serving kernel)")
    torch.cuda.empty_cache()
    (q_mid, k, v, mask, ids, valid, bs, _), _ = \
        kept.pop("sparse_band_attention")[0]
    k10_row = hold_k10(q_mid, k, v, mask, (ids, valid), bs,
                       "sparse_band_attn",
                       f"the title eval batch's encoder layer 0, rows of "
                       f"{mask.sum(1).tolist()} tokens", smi)
    del q_mid, k, v, mask
    train("train_title bart", argv_for(small["train"], small["val"],
                                       SMALL_BATCH, "--title_arch", "bart"),
          build / "title_ckpt_bart", 2)
    torch.cuda.empty_cache()
    return dict({key: k10_entry[key] for key in ("name", "route", "source",
                                                 "replaces")},
                launches=k10_eval, **k10_row,
                path="train_title --title_arch bigbird (eval; 0 launches "
                     "in its training steps)"), {"ckpt": str(ckpt),
                                                 "tsv": str(tsv)}


def evaluation_phase(dev, smi, cli_argv, window_eval, title_eval, entries):
    """The offline evaluation chain on the card: datasetkit/flatten over
    the inference phase's test split (2 synthetic videos of 120 s at
    224 px); cli/eval_segment on the window model from the window phase's
    auto checkpoint (launches a vision call exact: K6 1, the frames stem
    1, K2/K3 13, K4 3); cli/eval_segment on the frames-stem two-stream
    model from the inference phase's checkpoint, bf16 and --int8_vision
    (K9 10 a call, plus the bf16 calibration call), mAP and F1@3 side by
    side; cli/eval_title on Pegasus-large from the title_training phase's
    checkpoint as it was written, with --location gt, then --location pred
    on the window model's vid2cut_points.json with --num_beams 4, the
    CLI's ids of its first batch (before the trim at EOS) equal to a
    direct generate / beam_search of the same checkpoint restored here on
    the same inputs; then BigBird-Pegasus-large at 3072 tokens from
    seeded weights (K10: 16 launches an encode, two encodes a batch). Each
    run must restore its checkpoint (BigBird: none is kept) and write its
    result files with finite metrics; each Pegasus title must be
    non-empty. Every kernel of these paths is held to its plain version
    on the arguments of the path's own first vision call (K10: its first
    launch; the int8 run's bf16 stages: the bf16 run's, on the clips its
    calibration call takes). Returns the kernels' entries for these paths
    (those numbers, this phase's launches), and removes the checkpoints it
    was handed."""
    import os
    import shutil

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import (
        eval_segment,
        eval_title,
    )
    from video_chapter_generation_tpu_torch.cli.common import parse_config
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.core.metrics import StepTimer
    from video_chapter_generation_tpu_torch.data.tokenization import (
        UnigramTokenizer,
    )
    from video_chapter_generation_tpu_torch.datasetkit import flatten
    from video_chapter_generation_tpu_torch.models import resnet as resnet_model
    from video_chapter_generation_tpu_torch.models import (
        sparse_attention as sparse_model,
    )
    from video_chapter_generation_tpu_torch.models.seq2seq import (
        Seq2Seq,
        Seq2SeqConfig,
        beam_search,
        generate,
        trim_at_eos,
    )
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
    )
    from video_chapter_generation_tpu_torch.ops.stem import stem_frames
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        tsm_bottleneck_int8,
    )
    from video_chapter_generation_tpu_torch.pipeline import (
        boundary as boundary_model,
    )

    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    work = build / "evaluation"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counted = (normalize_frames, stem_frames, tsm_bottleneck,
               tsm_bottleneck_s2, tsm_bottleneck_int8, sparse_band_attention)
    laps, seen, rows = {}, {}, {}

    def run(name, fn):
        """fn() in the work directory (the CLIs write test_results/ where
        they run), every count at 0 just before and read just after, its
        stdout kept. Returns (fn's result, its stdout)."""
        for k in counted:
            k.launches = 0
        said = io.StringIO()
        cwd = os.getcwd()
        os.chdir(work)
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(said):
                out = fn()
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
            for line in said.getvalue().splitlines():
                print(f"# {name}: {line}", flush=True)
        laps[name] = time.time() - t0
        seen[name] = {k.__name__: k.launches for k in counted
                      if k.launches}
        print(f"# {name}: {laps[name]:.1f} s, launches {seen[name]} on "
              f"{smi}", flush=True)
        return out, said.getvalue()

    def check_segment(name, result, text, prefix, want):
        if "restored checkpoint at epoch" not in text:
            fail(f"{name} did not restore its checkpoint")
        if seen[name] != want:
            fail(f"{name} launch counts {seen[name]} != {want}")
        bad = {k: v for k, v in result.items() if k != "vid2cut_points"
               and not math.isfinite(v)}
        if bad:
            fail(f"{name}: metrics not finite {bad}")
        for path in (f"{prefix}.txt", f"{prefix}_vid2cut_points.json"):
            if not (work / path).is_file():
                fail(f"{name} wrote no {path}")

    def hold_first_call(name, kept, per_call):
        """The kernels of the run's first vision call, on its arguments."""
        got = {k: len(v) for k, v in kept.items()}
        if got != per_call:
            fail(f"{name}: kept {got} launches of its first vision call, "
                 f"want {per_call}")
        t0 = time.time()
        rows[name] = hold_vision_call(kept)
        print(f"# {name}: the first vision call's kernels held to their "
              f"plain versions on its own arguments in "
              f"{time.time() - t0:.1f} s on {smi}", flush=True)

    # --- flatten the inference corpus's test split ---
    cfg, _ = parse_config(cli_argv)
    d = cfg.data
    clips_json = work / "test_clips.json"
    run("flatten", lambda: flatten.main([
        "--img_dir", d.img_dir, "--data_file", d.data_file, "--vid_file",
        d.test_vid_file, "--subtitle_dir", d.subtitle_dir, "--out",
        str(clips_json), "--clip_frame_num", str(CLIP_FRAMES)]))
    n_clips = len(json.loads(clips_json.read_text()))
    if n_clips == 0:
        fail("flatten wrote no clips")

    # --- the window model (the README's evaluation) ---
    stage = {"normalize_frames": 1, "stem_frames": 1}
    per_call = dict(stage, tsm_bottleneck=13, tsm_bottleneck_s2=3)
    calls = math.ceil(n_clips / WINDOW_BATCH)
    timer = StepTimer()
    name = "eval_segment window"
    trunk_spots = {(boundary_model, "normalize_frames"): 1,
                   (resnet_model, "stem_frames"): 1,
                   (resnet_model, "tsm_bottleneck"): 13,
                   (resnet_model, "tsm_bottleneck_s2"): 3}
    with first_calls(trunk_spots) as kept:
        result, text = run(name, lambda: eval_segment.main(
            window_eval["argv"] + [f"data.test_clips_json={clips_json}",
                                   f"data.batch_size={WINDOW_BATCH}",
                                   "--bert_vocab", window_eval["vocab"]],
            timer=timer))
    check_segment(name, result, text, "test_results/two_stream_window_head_"
                  "mlp", {k: v * calls for k, v in per_call.items()})
    hold_first_call(name, kept, per_call)
    del kept
    cut_points = work / "test_results" / \
        "two_stream_window_head_mlp_vid2cut_points.json"
    window_cuts = {vid: v["second_pred_cut_points"] for vid, v in
                   json.loads(cut_points.read_text()).items()}
    dev_s = timer.summary()["device_score"]
    print(f"# {name}: {n_clips} clips in {calls} vision calls of "
          f"{WINDOW_BATCH} windows x 3 clips x {CLIP_FRAMES} frames; AUC "
          f"{result['AUC']:.4f} mAP {result['mAP']:.4f} F1@3 "
          f"{result['f1_3']:.4f}; device_score {dev_s['seconds']:.3f} s "
          f"({dev_s['items_per_sec']:.1f} clips/s); predicted cut points "
          f"{window_cuts}; on {smi}", flush=True)
    shutil.rmtree(parse_config(window_eval["argv"])[0].train.ckpt_dir,
                  ignore_errors=True)
    torch.cuda.empty_cache()

    # --- the frames-stem two-stream model, bf16 then --int8_vision ---
    from video_chapter_generation_tpu_torch.cli.common import (
        load_bert_tokenizer,
        load_corpus,
    )

    tok = load_bert_tokenizer(parse_config(cli_argv)[1],
                              load_corpus(cfg, "test"))
    vocab = work / "infer_vocab.txt"
    vocab.write_text("\n".join(sorted(tok.vocab, key=tok.vocab.get)) + "\n")
    calls = math.ceil(n_clips / SCORE_BATCH)
    calib = dict(stage, tsm_bottleneck=13, tsm_bottleneck_s2=3)
    wants = {"bf16": {k: v * calls for k, v in calib.items()},
             "int8": {k: v * calls + calib.get(k, 0) for k, v in dict(
                 stage, tsm_bottleneck=3, tsm_bottleneck_s2=3,
                 tsm_bottleneck_int8=10).items()}}
    scores = {}
    for mode, flags in (("bf16", []), ("int8", ["--int8_vision"])):
        name = f"eval_segment two_stream {mode}"
        timer = StepTimer()
        # bf16: the first vision call, whose clips the int8 run's bf16
        # calibration call takes too; int8: the W8A8 blocks of its first
        # int8 call
        spots = ({(resnet_model, "int8_bottleneck"): 10} if flags
                 else trunk_spots)
        with first_calls(spots) as kept:
            scores[mode], text = run(
                name, lambda flags=flags, timer=timer: eval_segment.main(
                    cli_argv + [f"data.test_clips_json={clips_json}",
                                "--bert_vocab", str(vocab)] + flags,
                    timer=timer))
        check_segment(name, scores[mode], text,
                      "test_results/two_stream_head_mlp", wants[mode])
        hold_first_call(name, kept, {"int8_bottleneck": 10} if flags
                        else per_call)
        del kept
        dev_s = timer.summary()["device_score"]
        print(f"# {name}: device_score {dev_s['seconds']:.3f} s "
              f"({dev_s['items_per_sec']:.1f} clips/s) on {smi}", flush=True)
    print("# eval_segment two_stream, bf16 against --int8_vision (the same "
          "checkpoint and clips; information only): "
          + ", ".join(f"{k} {scores['bf16'][k]:.4f} / {scores['int8'][k]:.4f}"
                      for k in ("AUC", "mAP", "recall_3", "precision_3",
                                "f1_3")), flush=True)
    torch.cuda.empty_cache()

    # --- Pegasus-large titles from the title_training checkpoint ---
    title_ckpt = title_eval["ckpt"]
    pieces = UnigramTokenizer.from_tsv(title_eval["tsv"])
    title_argv = [a for a in cli_argv if not a.startswith(
        ("train.ckpt_dir=", "data.batch_size="))] + [
        f"train.ckpt_dir={title_ckpt}", "model.compute_dtype=bfloat16",
        f"data.title_input_len={TITLE_IN}",
        f"data.title_decode_len={TITLE_OUT}", f"data.batch_size={TITLE_BATCH}",
        "--spm_tsv", title_eval["tsv"]]
    cuts_file = work / "window_vid2cut_points.json"
    shutil.copy(cut_points, cuts_file)
    direct = None  # the checkpoint restored here too, for the direct decode
    for loc, flags in (("gt", []), ("pred", [
            "--cut_points", str(cuts_file), "--num_beams", str(BEAMS)])):
        name = f"eval_title {loc}" + (f" beams {BEAMS}" if flags else "")
        decode = beam_search if flags else generate
        timer = StepTimer()
        with first_calls({(eval_title, decode.__name__): 1,
                          (eval_title, "trim_at_eos"): 1}) as kept:
            result, text = run(name, lambda flags=flags, loc=loc, timer=timer:
                               eval_title.main(title_argv + ["--location", loc]
                                               + flags, timer=timer))
        if "restored checkpoint at epoch" not in text:
            fail(f"{name} did not restore the title checkpoint")
        if not (math.isfinite(result["test_loss"])
                and math.isfinite(result["test_acc"])):
            fail(f"{name}: loss {result['test_loss']} acc "
                 f"{result['test_acc']}")
        # the CLI's first batch: its ids before the trim against the
        # direct decode of the same inputs, and its texts against theirs
        (cli_model, ids, mask), kw = kept[decode.__name__][0]
        (cli_ids, eos), _ = kept["trim_at_eos"][0]
        if direct is None:
            t0 = time.time()
            ck = CheckpointManager(title_ckpt)
            step = ck.best_step("title")
            _, state = ck.restore_raw(step)
            with torch.device("meta"):
                direct = Seq2Seq(cli_model.cfg)
            direct.load_state_dict(state["model"], assign=True)
            direct.to(dev, torch.bfloat16).eval()
            del state
            print(f"# the title checkpoint (epoch {step}) restored here for "
                  f"the direct decode: {time.time() - t0:.1f} s", flush=True)
        with torch.no_grad():
            want = decode(direct, ids, mask, **kw)
        want = (want[0] if flags else want).cpu().numpy()
        gen = result["gen_texts"]
        texts = [pieces.decode(list(r)) for r in trim_at_eos(cli_ids, eos)]
        print(f"# {name}: the CLI's ids of its first batch {cli_ids.shape} "
              f"{'equal' if np.array_equal(cli_ids, want) else 'UNEQUAL'} "
              f"to the direct {decode.__name__} of the restored checkpoint "
              f"on its inputs; first row {cli_ids[0][:8].tolist()}",
              flush=True)
        if not np.array_equal(cli_ids, want):
            fail(f"{name}: the CLI's ids differ from a direct "
                 f"{decode.__name__} on the same checkpoint and inputs")
        if gen[:len(texts)] != texts:
            fail(f"{name}: the CLI's titles are not the decoded ids")
        if not gen or not all(t.strip() for t in gen):
            fail(f"{name}: {sum(not t.strip() for t in gen)} of {len(gen)} "
                 f"titles empty")
        path = work / "test_results" / "chapter_title_gen" / \
            f"{loc}_batch_{TITLE_BATCH}.txt"
        lines = path.read_text().splitlines() if path.is_file() else []
        rouge_lines = [x for x in lines if x.startswith(
            ("random ", "lead ", "principal ", "rouge-"))]
        if len(rouge_lines) != 12:
            fail(f"{name}: {len(rouge_lines)} ROUGE lines in {path}")
        gen_s = timer.summary()["title_generate"]
        if loc == "gt":
            n_chapters = len(gen)
        print(f"# {name}: {len(gen)} chapters, loss {result['test_loss']:.4f} "
              f"acc {result['test_acc']:.4f}, generated rouge-1 f "
              f"{result['generated']['rouge-1']['f']:.4f}, first title "
              f"{gen[0]!r}; title_generate {gen_s['seconds']:.3f} s for "
              f"{gen_s['items']} titles on {smi}", flush=True)
        del kept, cli_model
    del direct
    shutil.rmtree(title_ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # --- BigBird-Pegasus-large titles at 3072 tokens (K10): no checkpoint
    # of its kind is kept, so the CLI seeds its weights as at any start;
    # the teacher-forced forward and the generate each encode a batch ---
    name = "eval_title gt bigbird"
    big_argv = [a for a in title_argv if not a.startswith(
        ("train.ckpt_dir=", "data.title_input_len="))] + [
        f"train.ckpt_dir={work / 'bigbird_ckpt'}",
        f"data.title_input_len={BIGBIRD_IN}", "--title_arch", "bigbird",
        "--location", "gt"]
    sparse_band_attention.serving_launches = 0
    timer = StepTimer()
    with first_calls({(sparse_model, "sparse_band_attention"): 1}) as kept:
        result, text = run(name, lambda: eval_title.main(big_argv,
                                                         timer=timer))
    gen = result["gen_texts"]
    batches = math.ceil(len(gen) / TITLE_BATCH)
    layers = Seq2SeqConfig.bigbird_pegasus_large().encoder_layers
    want = {"sparse_band_attention": 2 * layers * batches}
    if seen[name] != want or sparse_band_attention.serving_launches != \
            sparse_band_attention.launches:
        fail(f"{name} launch counts {seen[name]} != {want} (serving kernel "
             f"{sparse_band_attention.serving_launches})")
    if len(gen) != n_chapters or not math.isfinite(result["test_loss"]):
        fail(f"{name}: {len(gen)} titles for {n_chapters} chapters, loss "
             f"{result['test_loss']}")
    (q_mid, k, v, mask, ids, valid, bs, _), _ = \
        kept["sparse_band_attention"][0]
    del kept
    rows[name] = {"sparse_band_attention": hold_k10(
        q_mid, k, v, mask, (ids, valid), bs, "sparse_band_attn",
        f"the title eval's first launch, rows of {mask.sum(1).tolist()} "
        f"tokens", smi)}
    del q_mid, k, v, mask
    gen_s = timer.summary()["title_generate"]
    print(f"# {name}: {len(gen)} chapters of {BIGBIRD_IN} tokens, seeded "
          f"weights, loss {result['test_loss']:.4f}; title_generate "
          f"{gen_s['seconds']:.3f} s for {gen_s['items']} titles on {smi}",
          flush=True)
    print(f"# evaluation step seconds {json.dumps(laps)}", flush=True)

    # the int8 run's bf16 launches (its calibration call, then layer 1 and
    # the stride-2 blocks of each call) at the bf16 run's first-call rows:
    # the same clips, the same shapes
    rows["eval_segment two_stream int8"] = dict(
        rows["eval_segment two_stream bf16"],
        **rows["eval_segment two_stream int8"])
    paths = {"eval_segment window": "cli/eval_segment (window model)",
             "eval_segment two_stream bf16": "cli/eval_segment (two-stream)",
             "eval_segment two_stream int8": "cli/eval_segment --int8_vision",
             name: "cli/eval_title --title_arch bigbird"}
    return [dict({key: entries[k][key] for key in ("name", "route", "source",
                                                  "replaces")},
                 launches=seen[run_name][k], **row, path=path)
            for run_name, path in paths.items()
            for k, row in rows[run_name].items()]


def pretrain_lang_phase(dev, smi):
    """cli/pretrain_lang --task mlm at BERT-base width on the card: 3
    steps at batch 8, max_text_len 100, bf16, on a synthetic corpus of 24
    videos whose vocabulary is padded to BERT-base's; a finite loss,
    moved parameters and a checkpoint that restores. Prints ms a step (information only). No kernel of the port
    runs there."""
    import shutil

    import torch

    from video_chapter_generation_tpu_torch.cli import pretrain_lang
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.train.loop import Trainer

    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    paths = make_synth_corpus_on_disk(
        str(build / "synth_lang_corpus"), n_videos=24, video_sec=60, hw=32,
        seed=SEED + 31, splits={"train": 24})
    # the corpus's WordPiece vocabulary padded to BERT-base's 30,522
    # entries: the embedding and the MLM head at their published size
    from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
    from video_chapter_generation_tpu_torch.data.tokenization import (
        WordPieceTokenizer,
    )

    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["train_vid_file"],
                                    paths["subtitle_dir"])
    tok = WordPieceTokenizer.build_from_corpus(
        [s["text"] for vid in corpus.vids for s in corpus.subtitles(vid)],
        vocab_size=8000)
    words = sorted(tok.vocab, key=tok.vocab.get)
    words += [f"[unused{i}]" for i in range(BERT_VOCAB - len(words))]
    vocab = build / "lang_vocab.txt"
    vocab.write_text("\n".join(words) + "\n")
    ckpt = build / "lang_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    snap, times = {}, []
    plain_step = Trainer.train_step

    def spy(self, batch):
        if not snap:
            snap.update({k: p.detach().clone() for k, p in list(
                self.model.named_parameters())[::10]})
        torch.cuda.synchronize()
        t0 = time.time()
        m = plain_step(self, batch)
        loss = float(m["loss"].detach())
        times.append((loss, time.time() - t0))
        return m

    said = io.StringIO()
    Trainer.train_step = spy
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(said):
            trainer = pretrain_lang.main([
                f"data.img_dir={paths['img_dir']}",
                f"data.data_file={paths['data_file']}",
                f"data.subtitle_dir={paths['subtitle_dir']}",
                f"data.train_vid_file={paths['train_vid_file']}",
                "data.batch_size=8", f"data.max_text_len={TEXT_LEN}",
                "model.compute_dtype=bfloat16", "train.max_epochs=1",
                "train.resume=false", "optim.learning_rate=1e-3",
                f"train.ckpt_dir={ckpt}", f"train.log_dir={ckpt}_logs",
                "--task", "mlm", "--bert_vocab", str(vocab), "--device",
                str(dev)])
    finally:
        Trainer.train_step = plain_step
        for line in said.getvalue().splitlines():
            print(f"# pretrain_lang: {line}", flush=True)
    wall = time.time() - t0
    losses = [x[0] for x in times]
    params = dict(trainer.model.named_parameters())
    moved = sum(not torch.equal(v, params[k].detach())
                for k, v in snap.items())
    ck = CheckpointManager(str(ckpt))
    _, state = ck.restore_latest()
    same = all(torch.equal(v.cpu(), state["model"][k].cpu())
               for k, v in trainer.model.state_dict().items())
    step_ms = 1e3 * min(x[1] for x in times[1:] or times)
    print(f"# pretrain_lang --task mlm (BERT-base, vocabulary "
          f"{trainer.task.bert_cfg.vocab_size}, batch 8 x {TEXT_LEN} tokens, "
          f"bf16): {len(times)} steps, losses {[round(x, 4) for x in losses]}"
          f", {moved} of {len(snap)} sampled parameters moved, checkpoint "
          f"kind {ck.model_kind(ck.latest_step())!r} restores "
          f"{'bit for bit' if same else 'DIFFERENTLY'}; {step_ms:.1f} ms a "
          f"step (the fastest after the first), {wall:.1f} s in all on {smi};"
          f" information only", flush=True)
    if len(times) != 3 or not all(math.isfinite(x) for x in losses):
        fail(f"pretrain_lang: {len(times)} steps, losses {losses}")
    if trainer.task.bert_cfg.vocab_size != BERT_VOCAB:
        fail(f"pretrain_lang built a vocabulary of "
             f"{trainer.task.bert_cfg.vocab_size}")
    if not moved or not same or ck.model_kind(ck.latest_step()) != \
            "lang_pretrain":
        fail("pretrain_lang: parameters did not move or the checkpoint "
             "does not hold them")
    shutil.rmtree(ckpt, ignore_errors=True)


def variants_phase(dev, smi):
    """The secondary models and tools on the card, at full width:
    TwoStreamDomainSpecific (BERT-base, ResNet50-TSM frames stem T 16,
    window 1, hidden 128, bf16, seeded weights through the from_jax
    tables) serving DS_BATCH windows of 224-px frames with exact launches,
    each kernel of its vision call held to its plain version on that
    call's own arguments, and VARIANT_TRAIN_STEPS steps under
    make_grouped_optimizer (exact K11, K12 and K13 launches a step, finite
    losses, moved parameters), each training kernel held to its plain
    version on the first step's own arguments (the frames stem's, then
    each block fed the kernel output); SingleBlockWindowClassifier on seeded
    features against its float32 CPU run; cli/pretrain_contrastive
    (BERT-base, K 65,536, batch 8 x TEXT_LEN tokens, 3 steps; the queue
    pointer, the key encoder m k + (1 - m) q at each step) and
    cli/train_listwise (slates of 6 x TEXT_LEN tokens, batch 4, 3 steps);
    Grad-CAM at layer 4 on 16 frames (launches exact, its kernels held on
    the capture call's arguments, the cam in [0, 1] and within
    CAM_MIN_COS of the plain float32 trunk's on the CPU; a re-entry at
    stage 3 under auto raises); saliency and IG (IG_STEPS) on BERT-base;
    cli/convert_weights two_stream_window on a full-width reference-layout
    checkpoint made from seeded arrays (the converted model's scores
    equal the source model's bit for bit); device_trace writes a trace
    and device_memory_mb reads the allocation. Returns the kernels-line
    entries of its paths, each with its own numbers: the serving and
    Grad-CAM calls' per call, the training step's per step."""
    import shutil

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import (
        convert_weights,
        pretrain_contrastive,
        train_listwise,
    )
    from video_chapter_generation_tpu_torch.core.config import OptimConfig
    from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.data.tokenization import (
        WordPieceTokenizer,
    )
    from video_chapter_generation_tpu_torch.models import (
        convert,
        convert_reference,
    )
    from video_chapter_generation_tpu_torch.models import (
        resnet as resnet_model,
    )
    from video_chapter_generation_tpu_torch.models.bert import (
        BertConfig,
        BertForChapter,
        BertModel,
    )
    from video_chapter_generation_tpu_torch.models.contrastive import (
        MoCoTextEncoder,
    )
    from video_chapter_generation_tpu_torch.models.fusion import (
        TwoStreamWindow,
    )
    from video_chapter_generation_tpu_torch.models.fusion_variants import (
        SingleBlockWindowClassifier,
        TwoStreamDomainSpecific,
    )
    from video_chapter_generation_tpu_torch.models.resnet import (
        STAGE_SIZES,
        ResNet,
    )
    from video_chapter_generation_tpu_torch.ops.stem import stem_frames
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.train.objectives import (
        clip_classification_loss,
    )
    from video_chapter_generation_tpu_torch.train.optim import (
        clipped_step,
        make_grouped_optimizer,
    )
    from video_chapter_generation_tpu_torch.utils.memory import (
        device_memory_mb,
    )
    from video_chapter_generation_tpu_torch.utils.profiling import (
        annotate,
        device_trace,
    )
    from video_chapter_generation_tpu_torch.visualization.interpret import (
        grad_cam_vision,
        integrated_gradients_lang,
        saliency_lang,
    )

    bf = torch.bfloat16
    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    sizes = STAGE_SIZES[50]
    gen = torch.Generator(device=dev).manual_seed(VARIANTS_SEED)
    laps, rows, seen = {}, {}, {}
    serving = (stem_frames, tsm_bottleneck, tsm_bottleneck_s2)
    training = _train_counters("frames")
    vision_call = {"stem_frames": 1, "tsm_bottleneck": 13,
                   "tsm_bottleneck_s2": 3}
    spots = {(resnet_model, name): n for name, n in vision_call.items()}
    # the training step's entries into the kernels: the frames stem, then
    # the fused trunk
    train_spots = {(resnet_model, "stem_frames_train"): 1,
                   (resnet_model, "tsm_trunk_train"): 1}

    def lap(name, t0):
        laps[name] = round(time.time() - t0, 2)

    def zero(fns):
        for f in fns:
            f.launches = 0

    # --- TwoStreamDomainSpecific: serving ---
    t0 = time.time()

    def ds_model():
        with torch.device("meta"):
            return TwoStreamDomainSpecific(
                BertModel(BertConfig()),
                ResNet(50, n_segment=CLIP_FRAMES, dtype=bf), window_size=1,
                segment_size=CLIP_FRAMES, hidden_size=128, dtype=bf)

    ds = ds_model()
    ds_entries = convert.two_stream_domain_specific_entries(12, sizes)
    ds_sd = convert.from_jax_two_stream_domain_specific(
        convert.random_jax_tree(ds, ds_entries, seed=VARIANTS_SEED), 12,
        sizes)
    ds.load_state_dict(ds_sd, assign=True)
    ds.to_serving(dev)
    w = ds.num_clips
    img = torch.randn(DS_BATCH, w, CLIP_FRAMES, 224, 224, 3, generator=gen,
                      device=dev).to(bf)
    ids = torch.randint(1, BERT_VOCAB, (DS_BATCH, w, TEXT_LEN),
                        generator=gen, device=dev)
    mask = torch.ones_like(ids)
    mask[1, :, TEXT_LEN // 2:] = 0
    labels = torch.tensor([0, 1], device=dev)
    zero(serving)
    with first_calls(spots) as kept:
        _, probs = ds(img, ids, mask)
        torch.cuda.synchronize()
    seen["ds serve"] = {f.__name__: f.launches for f in serving}
    print(f"# variants TwoStreamDomainSpecific serving ({DS_BATCH} windows "
          f"x {w} clips x {CLIP_FRAMES} frames of 224 px, bf16): probs "
          f"{probs.tolist()}, launches {seen['ds serve']}", flush=True)
    if seen["ds serve"] != vision_call:
        fail(f"TwoStreamDomainSpecific serving launches {seen['ds serve']} "
             f"!= {vision_call}")
    if not (probs.shape == (DS_BATCH, 2) and torch.isfinite(probs).all()
            and (probs.sum(-1) - 1).abs().max() < 1e-3):
        fail(f"TwoStreamDomainSpecific serving probs malformed: {probs}")
    rows["ds serve"] = hold_vision_call(kept)
    del kept, ds
    torch.cuda.empty_cache()
    lap("ds_serve", t0)

    # --- TwoStreamDomainSpecific: training under the grouped optimizer ---
    t0 = time.time()
    ds = ds_model()
    ds.load_state_dict(ds_sd, assign=True)
    ds.to(dev).train()
    opt = make_grouped_optimizer(OptimConfig(learning_rate=1e-4), ds,
                                 ds_entries)
    before = {k: p.detach().clone() for k, p in ds.named_parameters()}
    per_step = {"stem_frames_train_fwd": 1, "stem_frames_train_bwd": 1,
                "tsm_block_train_fwd": 16, "tsm_block_train_bwd": 16,
                "tsm_trunk_train_finale_fwd": 1,
                "tsm_trunk_train_finale_bwd": 1,
                "tsm_trunk_train_link_fwd": 15,
                "tsm_trunk_train_link_bwd": 15,
                "tsm_trunk_train_recompute_p": 16}
    seen["ds train"] = dict.fromkeys(per_step, 0)
    losses, step_ms = [], []
    with first_calls(train_spots) as kept:
        for _ in range(VARIANT_TRAIN_STEPS):
            zero(training.values())
            torch.cuda.synchronize()
            t1 = time.time()
            opt.zero_grad(set_to_none=True)
            logits, _ = ds(img, ids, mask, train=True, generator=gen)
            loss, _ = clip_classification_loss(logits, labels)
            loss.backward()
            clipped_step(opt, ds.parameters(), 1.0)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.time() - t1))
            losses.append(loss.item())
            got = {name: f.launches for name, f in training.items()}
            if got != per_step:
                fail(f"TwoStreamDomainSpecific training launches {got} != "
                     f"{per_step}")
            for name, n in got.items():
                seen["ds train"][name] += n
    # an attention key bias has a zero gradient in exact arithmetic
    frozen = [k for k, p in ds.named_parameters()
              if torch.equal(p.detach(), before[k])
              and not k.endswith("key_proj.bias")]
    stats_moved = sum(not torch.equal(b.cpu(), ds_sd[k])
                      for k, b in ds.named_buffers()
                      if k.endswith("running_mean"))
    print(f"# variants TwoStreamDomainSpecific training: "
          f"{VARIANT_TRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]}, ms a step "
          f"{[round(x, 1) for x in step_ms]} (the first builds), launches a "
          f"step {per_step}, {len(before) - len(frozen)} of {len(before)} "
          f"parameters and {stats_moved} BN means moved on {smi}",
          flush=True)
    if not all(math.isfinite(x) for x in losses) or frozen or \
            not stats_moved:
        fail(f"TwoStreamDomainSpecific training: losses {losses}, frozen "
             f"{frozen[:4]}, {stats_moved} BN means moved")
    del ds, opt, before, ds_sd
    torch.cuda.empty_cache()
    lap("ds_train", t0)

    # --- its training kernels on the first step's own arguments ---
    t0 = time.time()
    (x_stem, w7, g, b, *_), _ = kept["stem_frames_train"][0]
    (x_trunk, block_params, kinds, n_seg, *_), _ = kept["tsm_trunk_train"][0]
    del kept
    train_entries, trunk_in, _ = hold_train_kernels(
        dev, gen, x_stem, [w7, g, b], block_params, kinds, n_seg)
    torch.cuda.synchronize()
    # the stem kernel on the kept frames gives the trunk the path gave
    if not torch.equal(trunk_in, x_trunk):
        fail("the training stem on the DS step's frames is not the trunk "
             "input of that step")
    rows["ds train"] = train_kernel_rows(
        train_entries, seen["ds train"],
        path=f"TwoStreamDomainSpecific training ({VARIANT_TRAIN_STEPS} "
             f"steps; numbers per step, on the first step's arguments)")
    del x_stem, w7, g, b, x_trunk, block_params, trunk_in
    torch.cuda.empty_cache()
    lap("ds_train_holds", t0)

    # --- SingleBlockWindowClassifier on seeded features ---
    t0 = time.time()
    sb = SingleBlockWindowClassifier(128, 16, 1)
    sb.load_state_dict(convert.from_jax_single_block_window(
        convert.random_jax_tree(sb, convert.single_block_window_entries(),
                                seed=VARIANTS_SEED + 1)))
    feats = torch.from_numpy(np.random.default_rng(VARIANTS_SEED).standard_normal(
        (8, 3, 128)).astype(np.float32))
    want_logits, _ = sb.eval()(feats)
    got_logits, got_probs = sb.to(dev)(feats.to(dev))
    err = (got_logits.cpu() - want_logits).abs().max().item()
    print(f"# variants SingleBlockWindowClassifier (hidden 128, 16 heads, "
          f"window 1, 8 windows, float32): max abs error to its CPU run "
          f"{err:.3g}", flush=True)
    if not err <= 1e-4 or not torch.allclose(got_probs.sum(-1),
                                             torch.ones(8, device=dev)):
        fail(f"SingleBlockWindowClassifier on the card is {err} from its "
             f"CPU run")
    lap("single_block", t0)

    # --- the text-training CLIs: a corpus, BERT-base's vocabulary ---
    t0 = time.time()
    paths = make_synth_corpus_on_disk(
        str(build / "synth_variants_corpus"), n_videos=36, video_sec=60,
        hw=32, seed=SEED + 43, splits={"train": 24, "val": 12})
    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["train_vid_file"],
                                    paths["subtitle_dir"])
    tok = WordPieceTokenizer.build_from_corpus(
        [s["text"] for vid in corpus.vids for s in corpus.subtitles(vid)],
        vocab_size=8000)
    words = sorted(tok.vocab, key=tok.vocab.get)
    words += [f"[unused{i}]" for i in range(BERT_VOCAB - len(words))]
    vocab = build / "variants_vocab.txt"
    vocab.write_text("\n".join(words) + "\n")
    base = [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.max_text_len={TEXT_LEN}", "model.compute_dtype=bfloat16",
            "train.max_epochs=1", "--bert_vocab", str(vocab), "--device",
            str(dev)]

    def run_cli(name, fn, argv, step_name, module):
        """fn(argv) with module.step_name timed a step; its stdout
        reprinted."""
        real = getattr(module, step_name)
        steps = []

        def spy(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.time()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.time() - t1))
            return out

        said = io.StringIO()
        setattr(module, step_name, spy)
        try:
            with contextlib.redirect_stdout(said):
                out = fn(argv)
        finally:
            setattr(module, step_name, real)
            for line in said.getvalue().splitlines():
                print(f"# {name}: {line}", flush=True)
        line = said.getvalue().splitlines()[-1]
        loss = float(line.split()[3])
        print(f"# {name}: {len(steps)} steps, ms a step "
              f"{[round(x, 1) for x in steps]} (the first builds) on {smi}",
              flush=True)
        if len(steps) != VARIANT_CLI_STEPS or not math.isfinite(loss):
            fail(f"{name}: {len(steps)} steps, loss {loss}")
        return out

    real_update = MoCoTextEncoder.momentum_update
    worst = []

    def momentum_spy(self):
        ks = [p.detach().double() for p in self.encoder_k.parameters()]
        qs = [p.detach().double() for p in self.encoder_q.parameters()]
        real_update(self)
        for k0, q0, k1 in zip(ks, qs, self.encoder_k.parameters()):
            ref = k0 * self.m + q0 * (1.0 - self.m)
            worst.append(((k1.double() - ref).abs().max()
                          / ref.abs().max().clamp_min(1e-30)).item())

    MoCoTextEncoder.momentum_update = momentum_spy
    try:
        enc = run_cli("pretrain_contrastive", pretrain_contrastive.main,
                      base + [f"data.train_vid_file={paths['train_vid_file']}",
                              f"data.batch_size={MOCO_BATCH}"],
                      "moco_step", pretrain_contrastive)
    finally:
        MoCoTextEncoder.momentum_update = real_update
    n_params = len(list(enc.encoder_k.parameters()))
    norms = enc.queue[:int(enc.queue_ptr)].float().norm(dim=-1)
    print(f"# pretrain_contrastive: K {enc.K}, queue_ptr "
          f"{int(enc.queue_ptr)}, enqueued key norms "
          f"{norms.min().item():.6f}..{norms.max().item():.6f}, key encoder "
          f"vs m k + (1 - m) q over {len(worst) // max(n_params, 1)} steps: "
          f"worst relative error {max(worst):.3g} (bf16's is "
          f"{2.0 ** -8:.3g})", flush=True)
    if enc.K != 65536 or int(enc.queue_ptr) != VARIANT_CLI_STEPS * \
            MOCO_BATCH or len(worst) != VARIANT_CLI_STEPS * n_params or \
            max(worst) > 2.0 ** -8 or (norms - 1).abs().max() > 1e-3:
        fail("pretrain_contrastive: the queue or the key encoder is off")
    del enc
    lw = run_cli("train_listwise", train_listwise.main,
                 base + [f"data.train_vid_file={paths['val_vid_file']}",
                         f"data.batch_size={LISTWISE_BATCH}"],
                 "listwise_step", train_listwise)
    init = lw.init_state(123)
    moved = sum(not torch.equal(p.detach().cpu(), init[k])
                for k, p in lw.named_parameters())
    if moved < len(init) // 2:
        fail(f"train_listwise moved {moved} of {len(init)} parameters")
    del lw, init
    shutil.rmtree(build / "synth_variants_corpus", ignore_errors=True)
    torch.cuda.empty_cache()
    lap("text_clis", t0)

    # --- Grad-CAM at layer 4 on ResNet50-TSM, 16 frames of 224 px ---
    t0 = time.time()
    with torch.device("meta"):
        vf = ResNet(50, n_segment=CLIP_FRAMES, dtype=bf)
    vsd = convert.from_jax_resnet(convert.random_jax_tree(
        vf, convert.resnet_entries(sizes), seed=VARIANTS_SEED + 2), sizes)
    vf.load_state_dict(vsd, assign=True)
    vf.to(dev).eval()
    frames = img[0, 1].contiguous()
    head_w = torch.randn(2048, 2, generator=gen, device=dev) / 2048 ** 0.5
    zero(serving)
    with first_calls(spots) as kept:
        cam = grad_cam_vision(vf, frames, class_index=1, stage=4,
                              head_fn=lambda p: p.float() @ head_w)
        torch.cuda.synchronize()
    seen["grad_cam"] = {f.__name__: f.launches for f in serving}
    cpu = ResNet(50, n_segment=CLIP_FRAMES).eval()
    cpu.load_state_dict(vsd)
    head_cpu = head_w.cpu()
    cam_ref = grad_cam_vision(cpu, frames.float().cpu(), class_index=1,
                              stage=4, head_fn=lambda p: p @ head_cpu)
    cos = compare(cam.cpu(), cam_ref)[2]
    print(f"# variants grad_cam_vision layer 4 ({tuple(frames.shape)} bf16): "
          f"cam {tuple(cam.shape)} in [{cam.min().item():.4f}, "
          f"{cam.max().item():.4f}], cosine {cos:.6f} to the plain float32 "
          f"trunk's on the CPU, launches {seen['grad_cam']}", flush=True)
    if seen["grad_cam"] != vision_call:
        fail(f"grad_cam launches {seen['grad_cam']} != {vision_call}")
    if not (cam.shape == (CLIP_FRAMES, 7, 7) and cam.min() >= 0
            and cam.max() <= 1 and cos >= CAM_MIN_COS):
        fail(f"grad_cam's cam is off: cosine {cos}")
    rows["grad_cam"] = hold_vision_call(kept)
    del kept, cpu
    capture = {}
    vf(frames, capture=capture)
    act = capture["stage3"].detach().requires_grad_()
    launched = tsm_bottleneck_s2.launches
    try:
        vf(act, from_stage=3)
    except NotImplementedError as exc:
        said = str(exc)
    else:
        fail("a stage-3 re-entry under tsm_impl auto did not raise")
    if "'tap3' or 'xla'" not in said or tsm_bottleneck_s2.launches != \
            launched:
        fail(f"the stage-3 re-entry raised {said!r} after "
             f"{tsm_bottleneck_s2.launches - launched} launches")
    print(f"# variants grad_cam stage 3 under auto raises: {said}",
          flush=True)
    del vf, act, capture
    lap("grad_cam", t0)

    # --- saliency and integrated gradients on BERT-base ---
    t0 = time.time()
    with torch.device("meta"):
        bc = BertForChapter(BertConfig())
    bc_entries = convert.bert_for_chapter_entries(12)
    bc.load_state_dict(convert.from_jax(convert.random_jax_tree(
        bc, bc_entries, seed=VARIANTS_SEED + 3), bc_entries), assign=True)
    bc.to(dev, bf).eval()
    ids4, mask4 = ids[:, 0], mask[:, 0]
    sal = saliency_lang(bc, ids4, mask4)
    ig = integrated_gradients_lang(bc, ids4, mask4, steps=IG_STEPS)
    for name, m in (("saliency", sal), ("integrated gradients", ig)):
        sums = m.sum(-1)
        print(f"# variants {name} (BERT-base bf16, {tuple(ids4.shape)}): "
              f"row sums {sums.tolist()}", flush=True)
        if not (torch.isfinite(m).all() and (sums - 1).abs().max() < 1e-3
                and m[1, TEXT_LEN // 2:].abs().max() == 0):
            fail(f"{name} rows do not sum to 1 over the real tokens")
    lap("saliency_ig", t0)

    # --- device_trace and device_memory_mb ---
    t0 = time.time()
    trace = build / "variants_trace"
    shutil.rmtree(trace, ignore_errors=True)
    with device_trace(str(trace)):
        with annotate("variants saliency"):
            saliency_lang(bc, ids4, mask4)
        torch.cuda.synchronize()
    written = [p for p in trace.rglob("*.json") if p.stat().st_size > 0]
    mem = device_memory_mb()
    print(f"# variants device_trace wrote {[p.name for p in written]} "
          f"({sum(p.stat().st_size for p in written)} bytes); "
          f"device_memory_mb {mem[0]}", flush=True)
    if not written or not mem or mem[0]["allocated_mb"] <= 0:
        fail("device_trace wrote no trace or device_memory_mb read nothing")
    shutil.rmtree(trace, ignore_errors=True)
    del bc
    lap("trace_memory", t0)

    # --- convert_weights two_stream_window at full width ---
    t0 = time.time()

    def window_model():
        with torch.device("meta"):
            return TwoStreamWindow(
                BertModel(BertConfig()), ResNet(50, n_segment=CLIP_FRAMES,
                                                dtype=bf),
                segment_size=CLIP_FRAMES, hidden_size=128, dtype=bf)

    tw = window_model()
    tw_sd = convert.from_jax_two_stream_window(convert.random_jax_tree(
        tw, convert.two_stream_window_entries(12, sizes),
        seed=VARIANTS_SEED + 4), 12, sizes)
    src, dst = build / "reference_window.pth", build / "converted_window.pt"
    ref = convert_reference.two_stream_window_to_reference(tw_sd)
    torch.save({"model_state_dict": {f"module.{k}": v
                                     for k, v in ref.items()}}, src)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        convert_weights.main(["--kind", "two_stream_window", "--torch_ckpt",
                              str(src), "--out", str(dst), "--window_size",
                              "1", "--head_type", "mlp"])
    conv = torch.load(dst, weights_only=True)
    same = conv.keys() == tw_sd.keys() and all(
        torch.equal(conv[k], tw_sd[k]) for k in tw_sd)
    tw.load_state_dict(tw_sd, assign=True)
    tw.to_serving(dev)
    tw2 = window_model()
    tw2.load_state_dict(conv, assign=True)
    tw2.to_serving(dev)
    _, p1 = tw(img, ids, mask)
    _, p2 = tw2(img, ids, mask)
    print(f"# variants convert_weights two_stream_window: "
          f"{said.getvalue().strip()}; state dict the source's bit for bit "
          f"{same}; scores {p1[:, 1].tolist()} vs {p2[:, 1].tolist()}",
          flush=True)
    if not same or not torch.equal(p1, p2):
        fail("convert_weights two_stream_window did not round-trip")
    for p in (src, dst):
        p.unlink()
    del tw, tw2, conv, ref, tw_sd
    torch.cuda.empty_cache()
    lap("convert_weights", t0)
    print(f"# variants laps {json.dumps(laps)}", flush=True)

    sources = {"stem_frames": ("csrc/stem_s2d.cu", "stem_pallas.py:255"),
               "tsm_bottleneck": ("csrc/tsm_bottleneck.cu",
                                  "tsm_block_pallas.py:1094"),
               "tsm_bottleneck_s2": ("csrc/tsm_bottleneck.cu",
                                     "tsm_block_pallas.py:654")}
    out = []
    for run, path in (("ds serve", "TwoStreamDomainSpecific serving"),
                      ("grad_cam", "grad_cam_vision (capture forward)")):
        for name, row in rows[run].items():
            src_file, replaces = sources[name]
            out.append(dict(
                name=name, route="cuda",
                source=f"video_chapter_generation_tpu_torch/{src_file}",
                replaces=f"video_chapter_generation_tpu/ops/{replaces}",
                launches=seen[run][name], **row, path=path))
    return out + rows["ds train"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _launcher_env(rank: int, world: int, port: int) -> dict:
    """The environment torchrun gives rank `rank` of `world` on one host,
    with this checkout on the import path."""
    import os

    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="localhost", MASTER_PORT=str(port),
                PYTHONPATH=str(ROOT) + (os.pathsep + path if path else ""))


def _run_ranks(cmds, cwds, envs, timeout):
    """Start every command at once; their outputs (stdout and stderr
    together), after all have ended. Any that outlives `timeout` is killed
    with the others, and the phase fails."""
    procs = [subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for cmd, cwd, env in zip(cmds, cwds, envs)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0].decode())
    except subprocess.TimeoutExpired:
        fail(f"a process outlived its {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for i, (proc, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            print(f"# process {i}: {line}", flush=True)
        if proc.returncode != 0:
            fail(f"process {i} of {len(procs)} exited {proc.returncode}")
    return outs


_NCCL_WORLD_ONE = r"""
import torch
import torch.distributed as tdist
from video_chapter_generation_tpu_torch.parallel import dist

assert dist.initialize(backend="nccl") and dist.backend() == "nccl"
# the port's collectives answer alone at world 1, as the JAX ones do
assert dist.all_gather_object({"a": 1}) == [{"a": 1}]
assert dist.broadcast_object([2], root=0) == [2]
dist.barrier("world one")
# and torch.distributed's, through NCCL on the card
out = [None]
tdist.all_gather_object(out, {"rank": 0, "blob": "x" * 4096})
assert out[0]["rank"] == 0 and len(out[0]["blob"]) == 4096
box = [("root", 3)]
tdist.broadcast_object_list(box, src=0)
assert box[0] == ("root", 3)
tdist.barrier(device_ids=[torch.cuda.current_device()])
t = torch.arange(4, dtype=torch.float32, device="cuda")
tdist.all_reduce(t)
torch.cuda.synchronize()
assert t.tolist() == [0.0, 1.0, 2.0, 3.0], t
dist.shutdown()
print("nccl at world 1: initialize, all_gather_object, broadcast_object, "
      "barrier, all_reduce OK")
"""


def parallel_phase(dev, smi, cli_argv, infer_run, window_eval, entries):
    """Sharded and multi-process serving on the card (parallel/,
    pipeline/sharded.py, cli/infer_video --sharded): (1) the card count
    and make_mesh()'s shape; (2) cli/infer_video --sharded with the
    inference phase's argv and checkpoint (--int8_vision --int8_titles
    --pipelined): on one card the mesh has one shard, so each video's cut
    points and titles, and the launch counts, equal that phase's
    unsharded run; (3) make_sharded_window_score_fn on a mesh of two
    shards on the one card, from the window phase's checkpoint, in
    batches of PARALLEL_BATCH windows: scores within PARALLEL_SCORE_TOL
    of the unsharded scorer's, labels equal wherever the unsharded score
    lies farther than that from 0.5, launches a call twice the one-shard
    counts, the kernels held to their plain versions on the first shard's
    arguments; (4) two processes of cli/infer_video with step 2's argv
    and a launcher's environment: gloo on a shared card (NCCL where each
    has a card), each serves vids[rank::2], rank 0's merged lines equal
    step 2's results; (5) NCCL at world 1 in a process of its own. Prints
    each step's wall time, device_score and title_generate. Returns the
    kernels' entries of steps 2 (the inference entries' numbers, at its
    same shapes, with its launches) and 3 (this phase's)."""
    import os
    import shutil

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import infer_video
    from video_chapter_generation_tpu_torch.cli.common import (
        load_bert_tokenizer,
        load_corpus,
        parse_config,
    )
    from video_chapter_generation_tpu_torch.cli.eval_segment import (
        build_score_fn,
    )
    from video_chapter_generation_tpu_torch.core.metrics import StepTimer
    from video_chapter_generation_tpu_torch.data.clip_grid import (
        flatten_video_to_clips,
    )
    from video_chapter_generation_tpu_torch.data.datasets import (
        InferWindowClipDataset,
    )
    from video_chapter_generation_tpu_torch.models import resnet as resnet_model
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        bn_relu_maxpool,
        stem_frames,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        tsm_bottleneck_int8,
    )
    from video_chapter_generation_tpu_torch.parallel import make_mesh
    from video_chapter_generation_tpu_torch.pipeline import (
        boundary as boundary_model,
    )
    from video_chapter_generation_tpu_torch.pipeline import (
        make_sharded_window_score_fn,
        score_clips,
    )

    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    work = build / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counted = (normalize_frames, stem_frames, bn_relu_maxpool,
               tsm_bottleneck, tsm_bottleneck_s2, tsm_bottleneck_int8)
    laps, seen = {}, {}

    def run(name, fn):
        """fn() in the work directory, every count at 0 just before and
        read just after, its stdout printed. Returns (result, stdout)."""
        for k in counted:
            k.launches = 0
        said = io.StringIO()
        cwd = os.getcwd()
        os.chdir(work)
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(said):
                out = fn()
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
            for line in said.getvalue().splitlines():
                print(f"# {name}: {line}", flush=True)
        laps[name] = time.time() - t0
        seen[name] = {k.__name__: k.launches for k in counted}
        print(f"# {name}: {laps[name]:.1f} s, launches "
              f"{ {k: v for k, v in seen[name].items() if v} } on {smi}",
              flush=True)
        return out, said.getvalue()

    # --- 1. the cards and the default mesh ---
    cards = torch.cuda.device_count()
    mesh = make_mesh()
    print(f"# parallel: torch.cuda.device_count() {cards}, make_mesh().shape "
          f"{mesh.shape} ({[str(d) for d in mesh.data_devices()]}) on {smi}",
          flush=True)

    # --- 2. infer_video --sharded, against the inference phase's run ---
    name2 = "infer_video --sharded"
    argv2 = cli_argv + ["--int8_vision", "--int8_titles", "--sharded",
                        "--pipelined"]
    results, text = run(name2, lambda: infer_video.main(argv2))
    got = {vid: (r.cut_points, r.titles) for vid, r in results.items()}
    stages = json.loads(text.split("stage seconds: ")[1].splitlines()[0])
    print(f"# {name2}: {len(got)} videos, device_score "
          f"{stages['device_score']['seconds']:.3f} s, title_generate "
          f"{stages['title_generate']['seconds']:.3f} s on {smi}", flush=True)
    if list(got) != list(infer_run["results"]):
        fail(f"{name2} chaptered {list(got)}, the unsharded run "
             f"{list(infer_run['results'])}")
    if mesh.shape["data"] == 1:
        if got != infer_run["results"]:
            fail(f"{name2} on a one-shard mesh: {got} != the unsharded run's "
                 f"{infer_run['results']}")
        if seen[name2] != infer_run["launches"]:
            fail(f"{name2} launch counts {seen[name2]} != the unsharded "
                 f"run's {infer_run['launches']}")
    print(f"# {name2}: cut points and titles "
          f"{'equal' if got == infer_run['results'] else 'DIFFER from'} the "
          f"unsharded run's, launches {seen[name2]} (unsharded "
          f"{infer_run['launches']})", flush=True)

    # --- 3. the window scorer on two shards of the one card ---
    name3 = "window scorer, 2 shards on one card"
    cfg, args = parse_config(window_eval["argv"]
                             + ["--bert_vocab", window_eval["vocab"]])
    tok = load_bert_tokenizer(args, load_corpus(cfg, "train"))
    val = load_corpus(cfg, "val")
    vid = val.vids[0]
    clips = flatten_video_to_clips(vid, val.img_dir, val.image_num(vid),
                                   val.raw_cut_secs(vid), val.subtitles(vid),
                                   CLIP_FRAMES)
    ds = InferWindowClipDataset(clips, tok, CLIP_FRAMES, TEXT_LEN,
                                window_size=1)
    plain_fn = build_score_fn(cfg, args, tok, device=dev)
    two = make_mesh(devices=[dev, dev])
    sharded_fn = make_sharded_window_score_fn(plain_fn.model, two)
    timers = {"one shard": StepTimer(), name3: StepTimer()}
    run("one shard", lambda: score_clips(ds, plain_fn, PARALLEL_BATCH,
                                         timer=timers["one shard"],
                                         prefetch=0))
    ref = np.asarray([c.pred_score for c in ds.all_clip_infos])
    trunk_spots = {(boundary_model, "normalize_frames"): 1,
                   (resnet_model, "stem_frames"): 1,
                   (resnet_model, "tsm_bottleneck"): 13,
                   (resnet_model, "tsm_bottleneck_s2"): 3}
    with first_calls(trunk_spots) as kept:
        run(name3, lambda: score_clips(ds, sharded_fn, PARALLEL_BATCH,
                                       timer=timers[name3], prefetch=0))
    shd = np.asarray([c.pred_score for c in ds.all_clip_infos])
    calls = math.ceil(len(ds) / PARALLEL_BATCH)
    one = {"normalize_frames": 1, "stem_frames": 1, "tsm_bottleneck": 13,
           "tsm_bottleneck_s2": 3}
    want = {k.__name__: calls * one.get(k.__name__, 0) for k in counted}
    if seen["one shard"] != want:
        fail(f"{name3}: one-shard launch counts {seen['one shard']} != "
             f"{want}")
    if seen[name3] != {k: 2 * v for k, v in want.items()}:
        fail(f"{name3}: launch counts {seen[name3]} != twice {want}")
    gap = float(np.abs(shd - ref).max())
    clear = np.abs(ref - 0.5) > PARALLEL_SCORE_TOL
    flips = int(((shd >= 0.5) != (ref >= 0.5))[clear].sum())
    print(f"# {name3}: {len(ds)} windows in {calls} calls of "
          f"{PARALLEL_BATCH} windows ({PARALLEL_BATCH // 2} x 3 x "
          f"{CLIP_FRAMES} = {PARALLEL_BATCH * 3 * CLIP_FRAMES // 2} frames a "
          f"shard); max |sharded - unsharded| score {gap:.3g} (band "
          f"{PARALLEL_SCORE_TOL}), {flips} labels flipped of "
          f"{int(clear.sum())} clear of the band; device_score "
          + ", ".join(f"{k} {t.summary()['device_score']['seconds']:.3f} s"
                      for k, t in timers.items()) + f" on {smi}", flush=True)
    if not np.isfinite(shd).all() or gap > PARALLEL_SCORE_TOL or flips:
        fail(f"{name3}: scores {gap:.3g} apart, {flips} labels flipped")
    got_calls = {k: len(v) for k, v in kept.items()}
    if got_calls != one:
        fail(f"{name3}: kept {got_calls} launches of the first shard")
    t0 = time.time()
    window_rows = hold_vision_call(kept)
    print(f"# {name3}: the first shard's kernels held to their plain "
          f"versions on its own arguments in {time.time() - t0:.1f} s on "
          f"{smi}", flush=True)
    del kept, plain_fn, sharded_fn
    torch.cuda.empty_cache()

    # --- 4. two processes of infer_video under a launcher's environment ---
    backend = "nccl" if cards >= 2 else "gloo"
    port = _free_port()
    dirs = [work / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    t0 = time.time()
    outs = _run_ranks(
        [[sys.executable, "-m", "video_chapter_generation_tpu_torch.cli."
          "infer_video", *argv2]] * 2, dirs,
        [_launcher_env(r, 2, port) for r in range(2)], PARALLEL_RANK_TIMEOUT)
    laps["2 processes"] = time.time() - t0
    vids = list(infer_run["results"])
    for r, out in enumerate(outs):
        line = f"process {r} of 2 (backend {backend}, "
        served = [x for x in out.splitlines() if x.startswith(line)]
        if not served or not served[0].endswith(f"serves "
                                                f"{json.dumps(vids[r::2])}"):
            fail(f"process {r} did not serve {vids[r::2]} on {backend}: "
                 f"{served}")
    lines = [json.loads(x) for x in outs[0].splitlines()
             if x.startswith('{"vid"')]
    merged = {x["vid"]: (x["cut_points"], x["titles"]) for x in lines}
    if list(merged) != vids or merged != got:
        fail(f"the 2-process run merged {merged}, the sharded run {got}")
    if any(x.startswith('{"vid"') for x in outs[1].splitlines()):
        fail("process 1 printed result lines: only the first writes them")
    print(f"# 2 processes of infer_video ({backend}): each served "
          f"vids[rank::2], rank 0's merged lines equal the sharded run's, "
          f"{laps['2 processes']:.1f} s (two model builds and calibrations "
          f"side by side) on {smi}", flush=True)

    # --- 5. NCCL at world 1 ---
    t0 = time.time()
    out = _run_ranks([[sys.executable, "-c", _NCCL_WORLD_ONE]], [work],
                     [_launcher_env(0, 1, _free_port())], 120)[0]
    laps["nccl world 1"] = time.time() - t0
    if "nccl at world 1:" not in out:
        fail("the NCCL check printed no result")
    print(f"# parallel step seconds {json.dumps(laps)} on {smi}", flush=True)

    shutil.rmtree(work, ignore_errors=True)
    rows = {"cli/infer_video --sharded --int8_vision --int8_titles": {
        k: {key: entries[k][key] for key in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")}
        for k, n in seen[name2].items() if n},
        "pipeline/sharded.py window scorer, 2 shards": window_rows}
    runs = {"cli/infer_video --sharded --int8_vision --int8_titles": name2,
            "pipeline/sharded.py window scorer, 2 shards": name3}
    return [dict({key: entries[k][key] for key in ("name", "route", "source",
                                                  "replaces")},
                 launches=seen[runs[path]][k], **row, path=path)
            for path, kernels in rows.items() for k, row in kernels.items()]


def gpt_phase(dev, smi):
    """The from-scratch GPT on the card: cli/pretrain_lang --task
    next_token_gpt (12 layers, 10 heads, 300 wide) and --task
    next_token_glove (12 heads over a random 300-d GloVe text file written
    here for the corpus's words), over the corpus's words padded to
    GPT_VOCAB (--glove_vocab), 3 steps each at batch 8 x TEXT_LEN
    tokens, bf16, on a synthetic corpus of 24 videos: finite losses,
    moved parameters, a checkpoint with the task's contract; then
    cli/sample_lang on each checkpoint, 2 prompts x 2 samples of 20
    tokens, top-k 10: two greedy runs give equal ids, two sampled runs
    with one seed equal ids. Prints ms a step (information only). No
    kernel of the port runs there."""
    import shutil

    import numpy as np
    import torch

    from video_chapter_generation_tpu_torch.cli import (
        pretrain_lang,
        sample_lang,
    )
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.core.contract import vocab_hash
    from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.datasetkit.glove import (
        build_word_vocab,
    )
    from video_chapter_generation_tpu_torch.train.loop import Trainer

    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    paths = make_synth_corpus_on_disk(
        str(build / "synth_gpt_corpus"), n_videos=24, video_sec=60, hw=32,
        seed=SEED + 41, splits={"train": 24})
    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["train_vid_file"],
                                    paths["subtitle_dir"])
    # the corpus's words padded to GPT_VOCAB (the head at that width);
    # GloVe rows for the corpus's words (the padding words have none: the
    # data set skips them, as it skips any word without a row)
    corpus_words = build_word_vocab(corpus)
    words = corpus_words + [f"<unused{i}>" for i in
                            range(GPT_VOCAB - len(corpus_words))]
    vocab = build / "gpt_vocab.txt"
    vocab.write_text("\n".join(words) + "\n")
    rng = np.random.default_rng(SEED + 43)
    glove = build / "gpt_glove.txt"
    glove.write_text("".join(
        w + " " + " ".join(f"{v:.5f}" for v in rng.standard_normal(300))
        + "\n" for w in corpus_words))
    over = [f"data.{k}={paths[k]}" for k in (
        "img_dir", "data_file", "subtitle_dir", "train_vid_file")] + [
        "data.batch_size=8", f"data.max_text_len={TEXT_LEN}",
        "model.compute_dtype=bfloat16", "train.max_epochs=1",
        "train.resume=false", "optim.learning_rate=1e-3",
        "--glove_vocab", str(vocab), "--device", str(dev)]
    widths = {"next_token_gpt": (12, 10, 300), "next_token_glove": (12, 12,
                                                                    300)}
    plain_step = Trainer.train_step
    for task, extra in (("next_token_gpt", []),
                        ("next_token_glove", ["--glove", str(glove)])):
        ckpt = build / f"gpt_ckpt_{task}"
        shutil.rmtree(ckpt, ignore_errors=True)
        argv = over + [f"train.ckpt_dir={ckpt}",
                       f"train.log_dir={ckpt}_logs", "--task", task] + extra
        snap, times = {}, []

        def spy(self, batch):
            if not snap:
                snap.update({k: p.detach().clone() for k, p in list(
                    self.model.named_parameters())[::7]})
            torch.cuda.synchronize()
            t0 = time.time()
            m = plain_step(self, batch)
            times.append((float(m["loss"].detach()), time.time() - t0))
            return m

        said = io.StringIO()
        Trainer.train_step = spy
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(said):
                trainer = pretrain_lang.main(argv)
        finally:
            Trainer.train_step = plain_step
            for line in said.getvalue().splitlines():
                print(f"# {task}: {line}", flush=True)
        wall = time.time() - t0
        gc = trainer.task.gpt_cfg
        losses = [x[0] for x in times]
        params = dict(trainer.model.named_parameters())
        moved = sum(not torch.equal(v, params[k].detach())
                    for k, v in snap.items())
        ck = CheckpointManager(str(ckpt))
        contract = ck.metrics_for(ck.latest_step())["contract"]
        step_ms = 1e3 * min(x[1] for x in times[1:] or times)
        print(f"# pretrain_lang --task {task} (GPT {gc.n_layer} layers, "
              f"{gc.n_head} heads, {gc.n_embd} wide, vocabulary "
              f"{gc.vocab_size}, batch 8 x {TEXT_LEN} tokens, bf16): "
              f"{len(times)} steps, losses {[round(x, 4) for x in losses]}, "
              f"{moved} of {len(snap)} sampled parameters moved, checkpoint "
              f"{contract}; {step_ms:.1f} ms a step (the fastest after the "
              f"first), {wall:.1f} s in all on {smi}; information only",
              flush=True)
        if len(times) != 3 or not all(math.isfinite(x) for x in losses):
            fail(f"{task}: {len(times)} steps, losses {losses}")
        if ((gc.n_layer, gc.n_head, gc.n_embd) != widths[task]
                or gc.vocab_size != GPT_VOCAB):
            fail(f"{task} trained a GPT of {gc}")
        kind = ("gpt_pretrain" if task == "next_token_gpt"
                else "gpt_glove_pretrain")
        if (not moved or contract.get("model_kind") != kind
                or contract.get("vocab_hash") != vocab_hash(words)
                or (task == "next_token_glove"
                    and contract.get("emb_dim") != 300)):
            fail(f"{task}: parameters moved {moved}, contract {contract}")
        del trainer
        torch.cuda.empty_cache()

        def sample(*flags):
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                out = sample_lang.main(
                    argv + ["--num_samples", "2", "--top_k", "10",
                            "--max_new_tokens", "20", *flags])
            return out, said.getvalue()

        t0 = time.time()
        greedy, text = sample("--greedy")
        greedy2, _ = sample("--greedy")
        drawn, drawn_text = sample()
        drawn2, _ = sample()
        sample_s = (time.time() - t0) / 4
        for line in (text + drawn_text).splitlines():
            print(f"# sample_lang {task}: {line}", flush=True)
        ids = [[s["ids"] for s in r] for r in (greedy, greedy2, drawn,
                                               drawn2)]
        print(f"# sample_lang --task {task}: {len(greedy)} greedy and "
              f"{len(drawn)} sampled continuations of 20 tokens, greedy runs "
              f"{'equal' if ids[0] == ids[1] else 'DIFFER'}, seeded sampled "
              f"runs {'equal' if ids[2] == ids[3] else 'DIFFER'}; "
              f"{sample_s:.1f} s a run (the restore included) on {smi}",
              flush=True)
        if len(greedy) != 4 or len(drawn) != 4:
            fail(f"sample_lang {task}: {len(greedy)} greedy, {len(drawn)} "
                 f"sampled continuations, not 4")
        if ids[0] != ids[1] or ids[2] != ids[3]:
            fail(f"sample_lang {task}: repeated runs gave other ids")
        if not all(len(x) == 20 and 0 <= min(x) and max(x) < len(words)
                   for run_ids in ids for x in run_ids):
            fail(f"sample_lang {task}: ids outside the vocabulary")
        shutil.rmtree(ckpt, ignore_errors=True)


class _Alone:
    """A moment group of one process whose reductions change nothing:
    under it the training kernels' entries run split at their moments
    (one call a phase), as under a group, with every count as alone."""
    size = 1

    def sum_(self, t):
        return t

    mean_ = sum_

    def count_scales(self, rows):
        return 1.0, 1.0


@contextlib.contextmanager
def split_alone():
    """The kernel wrappers see an _Alone moment group (the split path)."""
    from video_chapter_generation_tpu_torch.parallel import dist

    read = dist.moment_group
    dist.moment_group = _Alone
    try:
        yield
    finally:
        dist.moment_group = read


# counters of the training kernels' wrappers, by the names the training
# phase gives them
def _train_counters(stem: str = "s2d"):
    """The training kernels' wrappers by kernel-line name, the stem's
    named after its input (s2d or frames)."""
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_train_bwd,
        stem_train_fwd,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        block_train_bwd,
        block_train_fwd,
        finale_bwd,
        finale_fwd,
        trunk_link_bwd,
        trunk_link_fwd,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_trunk_train import (
        recompute_p,
    )

    return {f"stem_{stem}_train_fwd": stem_train_fwd,
            f"stem_{stem}_train_bwd": stem_train_bwd,
            "tsm_block_train_fwd": block_train_fwd,
            "tsm_block_train_bwd": block_train_bwd,
            "tsm_trunk_train_finale_fwd": finale_fwd,
            "tsm_trunk_train_finale_bwd": finale_bwd,
            "tsm_trunk_train_link_fwd": trunk_link_fwd,
            "tsm_trunk_train_link_bwd": trunk_link_bwd,
            "tsm_trunk_train_recompute_p": recompute_p}


def dp_rank_kernels() -> int:
    """One process of the data_parallel phase's kernel step (run under a
    launcher's environment, 2 processes on gloo): K11, K12 (projection,
    stride 1, stride 2) and a K13 link, forward and backward, at the
    shapes of a 2-process train_segment step (DP_CLIPS / 2 clips of
    CLIP_FRAMES frames at 224 px a process), held under the moment group
    to their plain versions (bn_train's group statistics) on this
    process's rows, and with the split entries alone (_Alone) bit for bit
    against the whole entries. Prints 'DP_KERNELS <json>' of the
    entries' numbers."""
    import torch
    import torch.distributed as tdist

    sys.path.insert(0, str(ROOT))
    from video_chapter_generation_tpu_torch.models.resnet import (
        ResNet,
        _hwio_view,
    )
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames_reference,
    )
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_s2d_train,
        stem_train_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        _block,
        tsm_block_train_reference,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_trunk_train import (
        STRIDES,
        trunk_reference,
        tsm_trunk_train,
        unpack,
    )
    from video_chapter_generation_tpu_torch.parallel import dist

    dist.initialize()
    rank, world = dist.process_index(), dist.process_count()
    if dist.backend() != "gloo":
        fail(f"process {rank}: backend {dist.backend()}, not gloo on a "
             f"shared card")
    dev = dist.default_device()
    # gloo must sum card tensors (NCCL refuses two processes on one card)
    probe = torch.full((4,), rank + 1.0, device=dev)
    tdist.all_reduce(probe)
    torch.cuda.synchronize()
    if probe.tolist() != [world * (world + 1) / 2] * 4:
        fail(f"gloo all_reduce of a card tensor gave {probe.tolist()}")
    mg = dist.MomentGroup(*dist.data_groups()[:2])
    bf, t = torch.bfloat16, CLIP_FRAMES
    per = DP_CLIPS // world * t
    rows = slice(rank * per, (rank + 1) * per)
    torch.manual_seed(SEED + 21)
    net = ResNet(50, n_segment=t, stem_input="s2d")
    with torch.no_grad():  # BN affines away from 1 and 0
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.mul_(1 + 0.2 * torch.randn_like(m.weight))
                m.bias.add_(0.1 * torch.randn_like(m.bias))
    net = net.to(dev)
    gen = torch.Generator().manual_seed(SEED + 22)

    def rows_of(*shape, u8=False):
        """This process's rows of a global tensor the same on every
        process."""
        full = (torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
                if u8 else torch.randn(shape, generator=gen).to(bf))
        return full[rows].to(dev).contiguous()

    entries = {}

    def leaves(ts):
        return [None if p is None else p.detach().clone().requires_grad_()
                for p in ts]

    def worst_of(got, ref, n_out, grad_band):
        """Each pair held to the output bands (the first n_out) or
        grad_band (min cosine, max mean relative error) -> the worst
        (max_abs, mean_rel, cos) of each kind, or the failure's text."""
        worst = {"out": (0.0, 0.0, 1.0), "grad": (0.0, 0.0, 1.0)}
        for i, (g, r) in enumerate(zip(got, ref)):
            key = "out" if i < n_out else "grad"
            max_abs, mean_rel, cos = compare(g, r)
            min_cos, max_rel = ((KERNEL_MIN_COS, KERNEL_MAX_MEAN_REL)
                                if key == "out" else grad_band)
            if not (cos >= min_cos and mean_rel <= max_rel):
                return (f"{key} {i}: max_abs {max_abs:.4g} mean_rel "
                        f"{mean_rel:.3g} cos {cos:.6f}")
            w = worst[key]
            worst[key] = (max(w[0], max_abs), max(w[1], mean_rel),
                          min(w[2], cos))
        return worst

    def averaged(outs, start):
        """outs with the parameters' gradients (from index start) averaged
        over the group, as the trainer averages them."""
        return outs[:start] + [mg.mean_(g.clone()) for g in outs[start:]]

    def check(name, label, kernel, plain, nbytes, flops, n_input=0,
              grad_band=(GRAD_MIN_COS, GRAD_MAX_MEAN_REL)):
        """kernel() and plain() -> ([outputs..., gradients...], n_out):
        n_out outputs, then n_input input gradients, then the parameters'
        gradients. Under the group the kernel against the plain version
        in the bands, each side's parameter gradients averaged over the
        group first, as the trainer averages them (the kernels take a BN's
        gamma and beta gradients from the group's moments, the plain
        version from this process's rows: the same after the average);
        alone the split entries against the whole ones bit for bit; then
        times under the group."""
        with dist.use_moments(mg):
            got, n_out = kernel()
            ref, _ = plain()
            got = averaged(got, n_out + n_input)
            ref = averaged(ref, n_out + n_input)
        torch.cuda.synchronize()
        worst = worst_of(got, ref, n_out, grad_band)
        if isinstance(worst, str):
            fail(f"process {rank}: {name} {label} under the moment group "
                 f"disagrees with its plain version: {worst}")
        whole, _ = kernel()
        with split_alone():
            split, _ = kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(whole, split)):
            fail(f"process {rank}: {name} {label}: the split entries alone "
                 f"differ from the whole entries")

        def under(fn):
            def run():
                with dist.use_moments(mg):
                    fn()
            return run

        k_ms, p_ms = cuda_ms(under(kernel)), cuda_ms(under(plain))
        kf_ms = cuda_ms(under(lambda: kernel(forward_only=True)))
        pf_ms = cuda_ms(under(lambda: plain(forward_only=True)))
        for direction, ms, pms, fl, nb in (
                ("fwd", kf_ms, pf_ms, flops, nbytes[0]),
                ("bwd", k_ms - kf_ms, p_ms - pf_ms, 2 * flops, nbytes[1])):
            e = entries.setdefault(f"{name}_{direction}", {
                "ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0,
                "max_abs": 0.0})
            e["ms"] += ms
            e["plain_ms"] += pms
            e["flops"] += fl
            e["bytes"] += nb
            e["max_abs"] = max(e["max_abs"], worst[
                "out" if direction == "fwd" else "grad"][0])
        print(f"# process {rank}: {name:15s} {label:40s} under the group vs "
              f"plain: outputs cos {worst['out'][2]:.6f} mean_rel "
              f"{worst['out'][1]:.3g}, grads cos {worst['grad'][2]:.6f} "
              f"mean_rel {worst['grad'][1]:.3g}; split alone bitwise True | "
              f"fwd kernel {kf_ms:.3f} ms plain {pf_ms:.3f} | fwd+bwd "
              f"kernel {k_ms:.3f} ms plain {p_ms:.3f}", flush=True)

    # --- K11: the training stem on this process's uint8 s2d cells ---
    x11 = rows_of(DP_CLIPS * t, 56, 56, 48, u8=True)
    stem = [_hwio_view(net.conv1).detach(), net.bn1.weight.detach(),
            net.bn1.bias.detach()]
    dy11 = rows_of(DP_CLIPS * t, 56, 56, 64)

    def k11(forward_only=False):
        ps = leaves(stem)
        out, (mu, var) = stem_s2d_train(x11, *ps, 1e-5, bf)
        if forward_only:
            return [out], 1
        return [out, mu, var, *torch.autograd.grad(out, ps, dy11)], 3

    def p11(forward_only=False):
        ps = leaves(stem)
        frames = normalize_frames_reference(depth_to_space4(x11), bf)
        out, (mu, var) = stem_train_reference(frames, *ps, 1e-5)
        if forward_only:
            return [out], 1
        return [out, mu, var, *torch.autograd.grad(out, ps, dy11)], 3

    cells = x11.shape[0] * 56 * 56
    check("stem_s2d_train", str(tuple(x11.shape)), k11, p11,
          (x11.numel() + 147 * 64 * 4 + cells * 64 * 2,
           2 * cells * 64 * 2 + x11.numel() + 147 * 64 * 4),
          2 * cells * 4 * 147 * 64)

    # --- K12: layer 1's block 0 (projection), block 1, layer 2's block 0
    # (stride 2) ---
    cases = [(net.layer1[0], 64), (net.layer1[1], 256), (net.layer2[0], 256)]
    for blk, c in cases:
        kind = blk.kind()
        stride = STRIDES[kind]
        params = [p.detach() if p is not None else None
                  for p in unpack(blk.train_params(), kind)]
        x = rows_of(DP_CLIPS * t, 56, 56, c)
        f, co = params[0].shape[-1], params[2].shape[-1]
        ho = 56 // stride
        dy = rows_of(DP_CLIPS * t, ho, ho, co)

        def k12(forward_only=False, x=x, params=params, stride=stride,
                dy=dy, fn=_block):
            xs = x.detach().clone().requires_grad_()
            ps = leaves(params)
            y, st = fn(xs, ps, stride, t, 8, 1e-5)
            if forward_only:
                return [y], 1
            wrt = [xs] + [p for p in ps if p is not None]
            return [y, *st, *torch.autograd.grad(y, wrt, dy)], 1 + len(st)

        def p12(forward_only=False, x=x, params=params, stride=stride,
                dy=dy):
            xs = x.detach().clone().requires_grad_()
            ps = leaves(params)
            w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = ps
            y, st = tsm_block_train_reference(
                xs, w1, w2, w3, g1, be1, g2, be2, g3, be3, t, 8, 1e-5, wp,
                gp, bep, stride)
            if forward_only:
                return [y], 1
            wrt = [xs] + [p for p in ps if p is not None]
            return [y, *st, *torch.autograd.grad(y, wrt, dy)], 1 + len(st)

        nt = x.shape[0]
        flops, m_in, m_out, nw = block_work(nt, 56, 56, c, f, co, stride,
                                            kind != "plain")
        act = 2 * (m_in * f + m_out * f + m_out * co * (3 if kind != "plain"
                                                        else 2))
        check("tsm_block_train", f"{tuple(x.shape)} F={f} {kind}", k12, p12,
              (x.numel() * 2 + nw * 4 + act,
               dy.numel() * 2 + x.numel() * 4 + act + nw * 8), flops, 1)

    # --- K13: a trunk of layer 1's blocks 0 and 1, one link each way ---
    blocks = [net.layer1[0], net.layer1[1]]
    kinds = [b.kind() for b in blocks]
    tparams = [[p.detach() for p in b.train_params()] for b in blocks]
    x13 = rows_of(DP_CLIPS * t, 56, 56, 64)
    dy13 = rows_of(DP_CLIPS * t, 56, 56, 256)

    def trunk_case(fn):
        def run(forward_only=False):
            xs = x13.detach().clone().requires_grad_()
            ps = [leaves(p) for p in tparams]
            y, stats = fn(xs, ps, kinds, t)
            outs = [y] + [s for st in stats for s in st]
            if forward_only:
                return [y], 1
            wrt = [xs] + [q for p in ps for q in p]
            return outs + list(torch.autograd.grad(y, wrt, dy13)), len(outs)
        return run

    def chain(xs, ps, kinds, t):
        """The per-block Functions (K12 alone), chained."""
        stats = []
        for p, kind in zip(ps, kinds):
            xs, st = _block(xs, unpack(p, kind), STRIDES[kind], t, 8, 1e-5)
            stats.append(st)
        return xs, stats

    # the trunk against the chain of per-block Functions, as the training
    # phase holds it alone: the forward bit for bit (the link reads and
    # computes what the chain's finale and conv1 do, and its moments are
    # summed over the group the same way), the gradients in the gradient
    # bands (the link sums the backward moments in another order)
    with dist.use_moments(mg):
        got, n_out = trunk_case(tsm_trunk_train)()
        ref, _ = trunk_case(chain)()
        got, ref = averaged(got, n_out + 1), averaged(ref, n_out + 1)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got[:n_out], ref[:n_out])):
        fail(f"process {rank}: the trunk's forward under the moment group "
             f"is not the chain's bit for bit")
    vs_chain = worst_of(got, ref, n_out, (GRAD_MIN_COS, GRAD_MAX_MEAN_REL))
    if isinstance(vs_chain, str):
        fail(f"process {rank}: the trunk's gradients under the moment group "
             f"leave the bands around the chain's: {vs_chain}")
    # alone, the trunk against its plain version (information: the band
    # the group's comparison is held to)
    got, _ = trunk_case(tsm_trunk_train)()
    ref, _ = trunk_case(trunk_reference)()
    alone = worst_of(got, ref, n_out, (TRUNK_GRAD_MIN_COS, math.inf))
    del got, ref
    print(f"# process {rank}: tsm_trunk_train under the group vs the chain "
          f"of per-block Functions: forward bitwise True, grads cos "
          f"{vs_chain['grad'][2]:.6f} mean_rel {vs_chain['grad'][1]:.3g}; "
          f"alone vs plain: grads cos {alone['grad'][2]:.6f} mean_rel "
          f"{alone['grad'][1]:.3g}", flush=True)
    fl = sum(block_work(x13.shape[0], 56, 56, c, 64, 256, 1,
                        kind != "plain")[0]
             for c, kind in zip((64, 256), kinds))
    m = x13.shape[0] * 56 * 56
    check("tsm_trunk_train", f"{tuple(x13.shape)} {'+'.join(kinds)}",
          trunk_case(tsm_trunk_train), trunk_case(trunk_reference),
          (2 * m * 64 + 2 * m * 256 * 4, 2 * m * 256 * 6 + 2 * m * 64), fl,
          1, (TRUNK_GRAD_MIN_COS, math.inf))

    print("DP_KERNELS " + json.dumps(entries), flush=True)
    dist.shutdown()
    return 0


def dp_rank_train(argv) -> int:
    """One process of a data_parallel training run: cli/train_segment or
    cli/train_title (argv[0]) with the rest of argv, dropout off, under a
    launcher's environment or alone; prints 'DP_RESULT <json>': the
    training kernels' launches, the micro-steps it ran, the median time of
    those after the first (synchronized), the optimizer state's bytes on
    this process, its peak memory_allocated, the epoch it started at and
    its losses. Before the CLI's arguments, --no-save records the
    checkpoint saves instead of writing them (a Pegasus-large checkpoint
    is 6.8 GB: the phase writes one, to keep the script's disk writes
    small) and
    --compare-to DIR compares this run's final state with the newest
    checkpoint in DIR (a 2-process run's, waited for): the cosine and max
    relative error of the parameters' change from the initial weights and
    of the AdamW moments; --wait-for FILE starts the CLI once FILE
    exists."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    from video_chapter_generation_tpu_torch.cli import (
        train_segment,
        train_title,
    )
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.models import (
        bert,
        fusion,
        seq2seq,
    )
    from video_chapter_generation_tpu_torch.train.loop import Trainer

    # dropout off, as in every parity check: each process draws its own
    # masks, one process another set over the whole batch
    for mod in (bert, fusion, seq2seq):
        mod.dropout = lambda x, p, on, generator=None: x
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    times, losses = [], []
    plain_step = Trainer.train_step

    def timed_step(self, batch):
        torch.cuda.synchronize()
        t0 = time.time()
        m = plain_step(self, batch)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(float(m["loss"].detach()))
        return m

    argv = list(argv)
    kind = argv.pop(0)
    saved, compare_to = [], None
    if "--no-save" in argv:
        argv.remove("--no-save")
        CheckpointManager.save = lambda self, epoch, *a, **k: saved.append(
            epoch)
    if "--compare-to" in argv:
        i = argv.index("--compare-to")
        compare_to = argv[i + 1]
        del argv[i:i + 2]
    if "--wait-for" in argv:
        i = argv.index("--wait-for")
        while not os.path.exists(argv[i + 1]):
            time.sleep(1.0)
        del argv[i:i + 2]
    init = {}
    plain_init = Trainer.__post_init__

    def keep_init(self):
        plain_init(self)
        if compare_to is not None:
            init.update({k: v.detach().to("cpu", copy=True) for k, v in
                         self.model.named_parameters()})

    Trainer.__post_init__ = keep_init
    Trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cli = {"segment": train_segment, "title": train_title}[kind]
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    compared = None
    if compare_to is not None:
        while CheckpointManager(compare_to).latest_step() is None:
            time.sleep(1.0)
        other = CheckpointManager(compare_to).restore_latest()[1]
        mine = trainer.state()
        keys = list(init)
        compared = {"update": _state_cmp(other["model"], mine["model"], init,
                                         keys)}
        for key in ("exp_avg", "exp_avg_sq"):
            compared[key] = _state_cmp(
                {str(i): st[key] for i, st in
                 other["optimizer"]["state"].items()},
                {str(i): st[key] for i, st in
                 mine["optimizer"]["state"].items()}, None,
                [str(i) for i in mine["optimizer"]["state"]])
        del other, mine
    opt = trainer.opt
    sharded = hasattr(opt, "state_bytes")
    state_bytes = (opt.state_bytes() if sharded else
                   sum(v.numel() * v.element_size()
                       for s in opt.state.values() for v in s.values()
                       if torch.is_tensor(v)))
    rest = sorted(times[1:]) or times
    print("DP_RESULT " + json.dumps({
        "launches": {k: fn.launches for k, fn in counters.items()},
        "steps": len(times), "start_epoch": trainer.start_epoch,
        "step_ms": 1e3 * rest[len(rest) // 2] if rest else None,
        "first_step_ms": 1e3 * times[0] if times else None,
        "losses": losses, "opt_bytes": state_bytes, "opt_sharded": sharded,
        "peak": torch.cuda.max_memory_allocated(trainer.device),
        "saves": saved, "compared": compared,
        "wall": time.time() - t0}), flush=True)
    return 0


def _dp_result(out: str, tag: str):
    """The JSON a process printed after `tag`."""
    lines = [x for x in out.splitlines() if x.startswith(tag + " ")]
    if not lines:
        fail(f"a data_parallel process printed no {tag} line")
    return json.loads(lines[-1][len(tag) + 1:])


def _state_cmp(a, b, init, keys):
    """(cosine, max relative error) of the change from init of the
    tensors keys of states a and b, over all of them as one vector; the
    relative error is the largest difference over the largest change of
    b."""
    import torch

    dot = na = nb = 0.0
    diff = top = 0.0
    for k in keys:
        x, y = a[k].double().cuda(), b[k].double().cuda()
        if init is not None:
            z = init[k].double().cuda()
            x, y = x - z, y - z
        dot += float((x * y).sum())
        na += float((x * x).sum())
        nb += float((y * y).sum())
        diff = max(diff, float((x - y).abs().max()))
        top = max(top, float(y.abs().max()))
    return dot / max(math.sqrt(na * nb), 1e-300), diff / max(top, 1e-300)


def data_parallel_phase(dev, smi):
    """Data-parallel training on the one card (train/loop.py over a
    process group, parallel/dist.py's moment group, ZeRO): (1) two gloo
    processes (dp_rank_kernels): K11, K12 and a K13 link held under the
    moment group to their plain versions on each process's rows, and
    split alone bit for bit against the whole entries; (2)
    cli/train_segment on the two-stream model (BERT-base, ResNet50-TSM,
    224 px s2d, tsm_impl=auto, dropout off) over DP_CLIPS clips a step, 4
    micro-steps with gradient_accumulation_steps=2 (2 updates), one
    process, two gloo processes on the card, and one process on the plain
    route (tsm_impl=xla, the bf16 noise floor): launches of each process
    equal to one process's; the first loss, the BN running averages and
    the AdamW moments of the text stream and the head held to the bands,
    the vision trunk's to the plain route's floor, per part (the
    parameters' update printed); (3) cli/train_title with Pegasus-large,
    two processes with ZeRO beside one process, 2 steps of DP_TITLE_BATCH
    chapters: each process's optimizer-state bytes at most
    DP_MAX_STATE_SHARE of the one process's, peak memory_allocated, the
    parameters' update and the AdamW moments compared; the 2-process
    checkpoint resumed by one process for a third epoch. Step times of 1
    and 2 processes printed as information (two processes share the
    card). Returns the kernels' entries (the numbers of step 1, the
    launches of step 2's processes)."""
    import os
    import shutil


    from video_chapter_generation_tpu_torch.cli.common import parse_config
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.data.tokenization import (
        UnigramTokenizer,
    )
    from video_chapter_generation_tpu_torch.train.optim import no_decay_mask
    from video_chapter_generation_tpu_torch.train.tasks import SegmentTask

    build = ROOT / "video_chapter_generation_tpu_torch" / "_build"
    work = build / "data_parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    me = [sys.executable, str(ROOT / "chip_smoke.py")]
    laps = {}

    # --- 1. the split kernels under the moment group, two processes ---
    t0 = time.time()
    port = _free_port()
    outs = _run_ranks([me + ["--dp-kernels"]] * 2, [work] * 2,
                      [_launcher_env(r, 2, port) for r in range(2)],
                      DP_RANK_TIMEOUT)
    laps["kernels"] = time.time() - t0
    held = _dp_result(outs[0], "DP_KERNELS")
    _dp_result(outs[1], "DP_KERNELS")
    print(f"# data_parallel: K11, K12 (projection, stride 1, stride 2) and "
          f"a K13 link held under the moment group of 2 gloo processes to "
          f"their plain versions, split alone bit for bit the whole entries, "
          f"{laps['kernels']:.1f} s on {smi}", flush=True)

    # --- 2. train_segment, one process and two ---
    n_train = DP_CLIPS * 4
    t0 = time.time()
    paths = make_synth_corpus_on_disk(
        str(work / "corpus"), n_videos=n_train + 1, video_sec=60,
        seed=SEED + 23, splits={"train": n_train, "val": 1})

    def seg_argv(name, impl="auto"):
        return ["segment", f"data.img_dir={paths['img_dir']}",
                f"data.data_file={paths['data_file']}",
                f"data.subtitle_dir={paths['subtitle_dir']}",
                f"data.train_vid_file={paths['train_vid_file']}",
                f"data.val_vid_file={paths['val_vid_file']}",
                "model.kind=two_stream", "model.stem_input=s2d",
                f"model.tsm_impl={impl}", f"data.batch_size={DP_CLIPS}",
                "optim.gradient_accumulation_steps=2", "train.max_epochs=1",
                f"train.ckpt_dir={work / ('seg_' + name)}",
                f"train.log_dir={work / ('seg_log_' + name)}",
                "train.resume=false"]

    base_env = dict(os.environ, PYTHONPATH=str(ROOT))
    runs = {}
    for name, world, impl in (("one", 1, "auto"), ("two", 2, "auto"),
                              ("plain", 1, "xla")):
        t1 = time.time()
        port = _free_port()
        envs = ([base_env] if world == 1 else
                [_launcher_env(r, 2, port) for r in range(2)])
        outs = _run_ranks([me + ["--dp-train"] + seg_argv(name, impl)]
                          * world, [work] * world, envs, DP_RANK_TIMEOUT)
        runs[name] = [_dp_result(o, "DP_RESULT") for o in outs]
        laps[f"segment {name}"] = time.time() - t1
    one, two = runs["one"][0], runs["two"]
    want = {k: v for k, v in one["launches"].items()}
    for r, res in enumerate(two):
        if res["launches"] != want:
            fail(f"process {r} of 2 launched {res['launches']}, one process "
                 f"{want}")
    if one["steps"] != 4 or any(r["steps"] != 4 for r in two):
        fail(f"micro-steps: one process {one['steps']}, two "
             f"{[r['steps'] for r in two]}, not 4")
    if not all(math.isfinite(v) for r in [one] + two for v in r["losses"]):
        fail("a data_parallel segment loss is not finite")
    # the 2-process run's first micro-step loss: the mean of the processes'
    first = (two[0]["losses"][0] + two[1]["losses"][0]) / 2
    cfg = parse_config(seg_argv("one")[1:])[0]
    task = SegmentTask(cfg)
    init = task.init_state()
    mask = no_decay_mask(task.model, task.entries)
    names = ([n for n, _ in task.model.named_parameters() if mask[n]]
             + [n for n, _ in task.model.named_parameters() if not mask[n]])

    def part(name):
        if name.startswith("lang_model."):
            return "text"
        if name.startswith("vision_model."):
            rest = name.split(".")[1]
            return ("vision " + rest if rest.startswith("layer")
                    else "vision stem")
        return "head"

    parts = sorted(set(part(n) for n in names)) + ["vision"]
    b = CheckpointManager(str(work / "seg_one")).restore_latest()[1]
    table = {}
    for other in ("two", "plain"):
        a = CheckpointManager(str(work / f"seg_{other}")).restore_latest()[1]
        if sorted(a["optimizer"]["state"]) != sorted(b["optimizer"]["state"]):
            fail(f"the {other} run's optimizer state has other entries")
        running = [k for k in b["model"] if "running" in k]
        row = {"running": _state_cmp(a["model"], b["model"], init, running)}
        for pt in parts:
            keys = [n for n in names if part(n).startswith(pt)]
            idx = [str(names.index(n)) for n in keys]
            row[f"update {pt}"] = _state_cmp(a["model"], b["model"], init,
                                             keys)
            for key in ("exp_avg", "exp_avg_sq"):
                row[f"{key} {pt}"] = _state_cmp(
                    {str(i): st[key] for i, st in
                     a["optimizer"]["state"].items()},
                    {str(i): st[key] for i, st in
                     b["optimizer"]["state"].items()}, None, idx)
        table[other] = row
        del a
    print(f"# data_parallel train_segment (two-stream BERT-base + "
          f"ResNet50-TSM 224 px, {DP_CLIPS} clips a step, 4 micro-steps, "
          f"2 updates, dropout off): launches per process {want}, equal to "
          f"one process's; first micro-step loss one process "
          f"{one['losses'][0]:.6f}, two {first:.6f}, the plain route "
          f"{runs['plain'][0]['losses'][0]:.6f}", flush=True)
    for key in table["two"]:
        (c2, r2), (cp, rp) = table["two"][key], table["plain"][key]
        print(f"#   {key:24s} 2 processes vs 1: cos {c2:.6f} max_rel "
              f"{r2:.3g} | 1 process plain route vs kernels: cos {cp:.6f} "
              f"max_rel {rp:.3g}", flush=True)
    # the bounds: the forward (first loss, running averages) and the
    # gradients of the parts without BatchNorm at the bf16 bands; the
    # vision trunk's against the one process's plain route, which lands
    # as far from the kernels (batch-stat BN amplifies bf16 rounding over
    # the blocks); the update is printed (Adam's first steps are near
    # lr * sign(gradient))
    bounds = [("running averages' update", table["two"]["running"][0],
               DP_MIN_COS)]
    bounds += [(f"{key} of the {pt}", table["two"][f"{key} {pt}"][0],
                DP_MIN_GRAD_COS) for pt in ("text", "head")
               for key in ("exp_avg", "exp_avg_sq")]
    bounds += [(f"{key} of the vision trunk",
                table["two"][f"{key} vision"][0],
                table["plain"][f"{key} vision"][0] - DP_VISION_SLACK)
               for key in ("exp_avg", "exp_avg_sq")]
    for what, cos, least in bounds:
        if not cos >= least:
            fail(f"data_parallel train_segment: the {what} of 2 processes "
                 f"is at cosine {cos:.6f} of one process's, below "
                 f"{least:.6f}")
    if abs(first - one["losses"][0]) > DP_LOSS_REL * abs(one["losses"][0]):
        fail(f"data_parallel train_segment: the first loss of 2 processes "
             f"{first} is not one process's {one['losses'][0]}")
    print(f"# data_parallel segment step (information only: two processes "
          f"share the one card): 1 process {one['step_ms']:.1f} ms a "
          f"micro-step of {DP_CLIPS} clips, 2 processes "
          f"{two[0]['step_ms']:.1f}, {two[1]['step_ms']:.1f} ms of "
          f"{DP_CLIPS // 2} clips each; peak memory_allocated one "
          f"{one['peak']} bytes, two {[r['peak'] for r in two]}; on {smi}",
          flush=True)
    del b, init

    # --- 3. train_title (Pegasus-large) with ZeRO, one process and two ---
    t1 = time.time()
    tpaths = make_synth_corpus_on_disk(
        str(work / "title_corpus"), n_videos=DP_TITLE_BATCH + 1,
        video_sec=96, hw=32, seed=SEED + 24,
        splits={"train": DP_TITLE_BATCH, "val": 1})
    corpus = VideoCorpus.from_files(tpaths["img_dir"], tpaths["data_file"],
                                    tpaths["train_vid_file"],
                                    tpaths["subtitle_dir"])
    tok = UnigramTokenizer.build_from_corpus(
        [s["text"] for vid in corpus.vids for s in corpus.subtitles(vid)],
        vocab_size=8000)
    pieces = dict(tok.pieces)
    specials = {tok.pad_token, tok.eos_token, tok.unk_token}
    low = min(pieces.values()) - 10.0
    n = len(specials) + len([q for q in pieces if q not in specials])
    pieces.update({f"<unused{i}>": low for i in range(PEGASUS_VOCAB - n)})
    tsv = work / "title_pieces.tsv"
    tsv.write_text("".join(f"{q}\t{v}\n" for q, v in pieces.items()))

    def title_argv(name, epochs=2, resume=False, ckpt=None):
        return ["title", f"data.img_dir={tpaths['img_dir']}",
                f"data.data_file={tpaths['data_file']}",
                f"data.subtitle_dir={tpaths['subtitle_dir']}",
                f"data.train_vid_file={tpaths['train_vid_file']}",
                f"data.val_vid_file={tpaths['val_vid_file']}",
                "model.compute_dtype=bfloat16",
                f"data.batch_size={DP_TITLE_BATCH}",
                f"data.title_input_len={TITLE_IN}",
                f"data.title_decode_len={TITLE_OUT}", "optim.lr_decay=false",
                f"train.max_epochs={epochs}", "train.eval_every_epochs=100",
                "train.save_every_epochs=100",
                f"train.ckpt_dir={ckpt or work / ('title_' + name)}",
                f"train.log_dir={work / ('title_log_' + name)}",
                f"train.resume={str(resume).lower()}", "--spm_tsv", str(tsv)]

    # all at once (their step times are no speed figure: four processes
    # share the card): two processes write the one checkpoint of this step
    # (6.8 GB); one process trains alone, writes nothing and compares its
    # state with that checkpoint once it is there; one process waits for
    # it, resumes it for a third epoch and writes nothing
    t2 = time.time()
    port = _free_port()
    one_argv = title_argv("one")
    res_argv = title_argv("resumed", 3, True, work / "title_two")
    outs = _run_ranks(
        [me + ["--dp-train"] + title_argv("two")] * 2
        + [me + ["--dp-train", one_argv[0], "--no-save", "--compare-to",
                 str(work / "title_two")] + one_argv[1:],
           me + ["--dp-train", res_argv[0], "--no-save", "--wait-for",
                 str(work / "title_two" / "ckpt_1.pt")] + res_argv[1:]],
        [work] * 4, [_launcher_env(r, 2, port) for r in range(2)]
        + [base_env] * 2, DP_RANK_TIMEOUT)
    laps["title"] = time.time() - t2
    *ttwo, tone, res = [_dp_result(o, "DP_RESULT") for o in outs]
    shares = [r["opt_bytes"] / tone["opt_bytes"] for r in ttwo]
    if not all(r["opt_sharded"] for r in ttwo):
        fail("the 2-process title run's optimizer state is not sharded")
    cmp_t = tone["compared"]
    print(f"# data_parallel train_title (Pegasus-large, ZeRO, "
          f"{DP_TITLE_BATCH} chapters a step, 2 steps, dropout off): "
          f"optimizer state bytes one process {tone['opt_bytes']}, two "
          f"{[r['opt_bytes'] for r in ttwo]} "
          f"({', '.join(f'{x:.4f}' for x in shares)} of one's); peak "
          f"memory_allocated one {tone['peak']}, two "
          f"{[r['peak'] for r in ttwo]} bytes; 2 processes vs 1: parameters' "
          f"update cos {cmp_t['update'][0]:.6f} max_rel "
          f"{cmp_t['update'][1]:.3g}, exp_avg cos {cmp_t['exp_avg'][0]:.6f} "
          f"max_rel {cmp_t['exp_avg'][1]:.3g}, exp_avg_sq cos "
          f"{cmp_t['exp_avg_sq'][0]:.6f}; step (side by side, information "
          f"only) one "
          f"{tone['step_ms']:.1f} ms, two {ttwo[0]['step_ms']:.1f}, "
          f"{ttwo[1]['step_ms']:.1f} ms; losses one {tone['losses']} two "
          f"{[r['losses'] for r in ttwo]} on {smi}", flush=True)
    if max(shares) > DP_MAX_STATE_SHARE:
        fail(f"with ZeRO each process keeps {shares} of one process's "
             f"optimizer state, above {DP_MAX_STATE_SHARE}")
    if not (cmp_t["update"][0] >= DP_MIN_UPDATE_COS
            and cmp_t["exp_avg"][0] >= DP_MIN_COS
            and cmp_t["exp_avg_sq"][0] >= DP_MIN_COS):
        fail(f"data_parallel train_title: 2 processes vs 1 {cmp_t}")
    # the 2-process checkpoint, resumed by one process for a third epoch
    if (res["start_epoch"] != 2 or res["steps"] != 1 or res["saves"] != [2]
            or not all(math.isfinite(v) for v in res["losses"])):
        fail(f"one process did not resume the 2-process title checkpoint "
             f"for its third epoch: {res}")
    print(f"# data_parallel: the 2-process title checkpoint resumed in one "
          f"process at epoch {res['start_epoch']}: 1 step, loss "
          f"{res['losses']}; phase steps {json.dumps(laps)} on {smi}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)

    sources = {
        "stem_s2d_train": ("csrc/stem_train.cu", (
            "video_chapter_generation_tpu/ops/stem_train_pallas.py:329")),
        "tsm_block_train": ("csrc/conv_train.cu", (
            "video_chapter_generation_tpu/ops/"
            "tsm_block_train_pallas.py:1483")),
        "tsm_trunk_train": ("csrc/conv_train.cu", (
            "video_chapter_generation_tpu/ops/"
            "tsm_trunk_train_pallas.py:118"))}
    counted = {"stem_s2d_train_fwd": "stem_s2d_train_fwd",
               "stem_s2d_train_bwd": "stem_s2d_train_bwd",
               "tsm_block_train_fwd": "tsm_block_train_fwd",
               "tsm_block_train_bwd": "tsm_block_train_bwd",
               "tsm_trunk_train_fwd": "tsm_trunk_train_link_fwd",
               "tsm_trunk_train_bwd": "tsm_trunk_train_link_bwd"}
    out = []
    for key, e in held.items():
        name = key.rsplit("_", 1)[0]
        b_ms, b_by = bound(e["flops"], e["bytes"])
        src, replaces = sources[name]
        out.append({
            "name": counted[key], "route": "cuda",
            "source": f"video_chapter_generation_tpu_torch/{src}",
            "replaces": replaces, "launches": two[0]["launches"][counted[key]],
            "max_abs_err": e["max_abs"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "path": "data_parallel: 2 gloo processes on one card, split at "
                    "the BN moments under the moment group"
                    + (" (a 2-block trunk, one link)"
                       if name == "tsm_trunk_train" else "")})
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
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )
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

    t_start = time.time()
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
    # float32 on the host: the inference CLI phase checkpoints it
    ts_sd = convert.from_jax_two_stream(ts_tree, 12, sizes)
    model.load_state_dict(ts_sd, assign=True)
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
    stats = {name: {"ms": [], "plain_ms": [], "library_ms": None,
                    "max_abs": 0.0, "work": []}
             for name in ("stem_s2d", "tsm_bottleneck", "tsm_bottleneck_s2")}

    def check(name, label, kernel, plain, flops, nbytes, library=None):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        max_abs, mean_rel, cos = compare(got, ref)
        k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
        st = stats[name]
        st["ms"].append(k_ms)
        st["plain_ms"].append(p_ms)
        st["max_abs"] = max(st["max_abs"], max_abs)
        st["work"].append((flops, nbytes))
        b_ms, b_by = bound(flops, nbytes)
        lib = ""
        if library is not None:  # a yardstick: timed, held loosely, printed
            l_ms = cuda_ms(library)
            l_cos = compare(library().permute(0, 2, 3, 1), got)[2]
            st["library_ms"] = (st["library_ms"] or 0.0) + l_ms
            lib = f" library {l_ms:.3f} ms (cos {l_cos:.4f})"
        print(f"# {name:18s} {label:44s} max_abs {max_abs:.4g} mean_rel "
              f"{mean_rel:.3g} cos {cos:.6f} | kernel {k_ms:.3f} ms plain "
              f"{p_ms:.3f} ms{lib} bound {b_ms:.3f} ms ({b_by})", flush=True)
        if not (cos >= KERNEL_MIN_COS and mean_rel <= KERNEL_MAX_MEAN_REL):
            fail(f"{name} {label} disagrees with its plain version")
        return got

    n_fr, hs = frames.shape[0], frames.shape[1]
    # the yardstick runs on the frames normalized ahead (K6's work)
    stem_lib = library_stem(normalize_frames(depth_to_space4(frames), bf),
                            stem_p["w7"], stem_p["s"], stem_p["b"])
    y = check("stem_s2d", f"{tuple(frames.shape)} u8",
              lambda: stem_s2d(frames, stem_p["w7"], stem_p["s"],
                               stem_p["b"]),
              lambda: stem_s2d_reference(frames, stem_p["w7"], stem_p["s"],
                                         stem_p["b"]),
              2 * n_fr * 4 * hs * hs * 147 * 64,
              frames.numel() + 147 * 64 * 2 + n_fr * hs * hs * 64 * 2,
              library=stem_lib)
    del stem_lib
    try:
        parts = stem_parts(frames, stem_p["w7"], stem_p["s"], stem_p["b"])
    except Exception as exc:  # the split is information only
        parts = f"not measured ({type(exc).__name__}: {exc})"
    print(f"# K1 device ms a {n_fr}-frame vision call by part: {parts} on "
          f"{smi}", flush=True)
    layers = [f"layer{k + 1}" for k, n in enumerate(sizes) for _ in range(n)]
    split_runs = []  # (layer, proj, the block's kernel call)
    for i, (blk, p) in enumerate(zip(vision.blocks(), block_ps)):
        args = (p["w1"], p["w2"], p["w3"], p["s1"], p["b1"], p["s2"],
                p["b2"], p["s3"], p["b3"])
        x = y
        library = library_block(x, *args, p["wp"], p["sp"], p["bp"],
                                blk.stride, CLIP_FRAMES)
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
            name = "tsm_bottleneck_s2"
            kernel = (lambda x=x, args=args, p=p: tsm_bottleneck_s2(
                x, *args, p["wp"], p["sp"], p["bp"], CLIP_FRAMES))
        else:
            name = "tsm_bottleneck"
            kernel = (lambda x=x, args=args, p=p: tsm_bottleneck(
                x, *args, CLIP_FRAMES, 8, p["wp"], p["sp"], p["bp"]))
        y = check(name, label, kernel, plain, *work, library=library)
        split_runs.append((layers[i], p["wp"] is not None, kernel))
        del library
    try:
        split = serving_split(split_runs)
    except Exception as exc:  # the split is information only
        split = f"not measured ({type(exc).__name__}: {exc})"
    print(f"# K2/K3 and K4 device ms a {n_fr}-frame vision call by conv and "
          f"layer ({len(split_runs)} blocks, one traced call each): {split} "
          f"on {smi}", flush=True)
    del split_runs

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
    steps = sum(math.ceil(len(r.titles) / TITLE_BUCKET)
                for r in results.values()) * TITLE_OUT
    title_s = pipe.timer.summary()["title_generate"]["seconds"]
    print(f"# bf16 title decode (Pegasus-large, batch {TITLE_BUCKET}): "
          f"{1e3 * title_s / steps:.2f} ms per greedy step over {steps} "
          f"steps", flush=True)
    print(f"# {60.0 * len(results) / wall:.2f} videos/min end to end "
          f"({wall:.1f} s for {len(results)} videos, pipelined) on {smi}; "
          f"information only, not a benchmark", flush=True)

    laps = {"serving": time.time() - t_start}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        laps[name] = time.time() - t0
        print(f"# phase {name}: {laps[name]:.1f} s", flush=True)
        return out

    native_launches = timed("native_decode", native_decode_phase, dev, smi,
                            pipe, corpus)
    timed("title_decode", title_decode_phase, dev, smi, s2s)
    infer_kernels, cli_argv, infer_run = timed(
        "infer", infer_phases, dev, smi, frames, vision, ts_sd, delta)
    del ts_sd, s2s
    torch.cuda.empty_cache()
    bigbird_kernels, bigbird_run = timed("bigbird", bigbird_phases, dev,
                                         smi, cli_argv)
    # the HF imports: ResNet-50's vision call, the bigbird phase's encode
    hf_kernels = timed("hf_import", hf_import_phase, dev, smi, *bigbird_run)
    del bigbird_run
    torch.cuda.empty_cache()
    train_kernels = timed("training", training_phases, dev, smi, frames,
                          vision)
    window_kernels, window_eval = timed("window", window_phases, dev, smi,
                                        frames, vision)
    int8_s2_kernels = timed("int8_s2", int8_s2_phases, dev, smi, frames,
                            vision, cli_argv)
    chain_kernel = timed("chain", chain_phases, dev, smi, frames, vision)
    timed("wide", wide_phases, dev, smi, vision)

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
        b_ms, b_by = bound_sum(st["work"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"video_chapter_generation_tpu_torch/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": st["max_abs"],
            # per vision call: the sum over the shapes one call runs; the
            # bound the sum of each shape's; library: the cuDNN sequence
            "ms": sum(st["ms"]), "plain_ms": sum(st["plain_ms"]),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": st["library_ms"]})
    # inference CLI entries: per 256-frame vision call; K10: per encoder
    # layer at the BigBird serving shape (its ring and mma.sync kernels
    # at the first held shape each takes, every such shape under "held"),
    # launches from the CLI run;
    # training entries: per step, the sum over the shapes one step runs;
    # K5 (both entries), K7: per 256-frame vision call; K6: one 16-clip
    # call's frames; their launches from the window phases' runs; K14a,
    # K14b and K15: per 256-frame vision call, launches from the
    # INT8_S2_BLOCKS and chain_blocks vision calls (K14b: no model path)
    # the extraction paths: K1, K2/K3 and K4 (and K9 with --int8) at the
    # shapes of the serving and inference entries, launches of this phase
    # sharded and multi-process serving from the inference and window
    # checkpoints (before title_training adds a title checkpoint beside
    # the inference one, and before the evaluation removes them): the
    # --sharded CLI's entries carry the serving, inference and window
    # entries' numbers (its shapes are theirs), the two-shard window
    # scorer's its own
    parallel_kernels = timed(
        "parallel", parallel_phase, dev, smi, cli_argv, infer_run,
        window_eval, {k["name"]: k for k in kernels + infer_kernels
                      + window_kernels})
    vision_kernels = timed(
        "vision_titles", vision_titles_phase, dev, smi, cli_argv,
        {k["name"]: k for k in kernels},
        next(k for k in infer_kernels if k["name"] == "tsm_bottleneck_int8"))
    # title training: K10 on the BigBird eval's inputs, its launches in
    # that eval (none in its training steps); the native decode path: K1-K4 at the serving
    # entries' shapes, this phase's launches
    title_kernel, title_eval = timed(
        "title_training", title_training_phase, dev, smi, cli_argv,
        str(ROOT / "video_chapter_generation_tpu_torch" / "_build"
            / "vision_embs_bf16"), bigbird_kernels[0])
    # the offline evaluation chain from the window, inference and title
    # checkpoints: K6, K8, K2/K3 and K4 (and K9 with --int8_vision) with
    # the serving, inference and window entries' times, this phase's
    # launches
    eval_kernels = timed(
        "evaluation", evaluation_phase, dev, smi, cli_argv, window_eval,
        title_eval, {k["name"]: k for k in kernels + infer_kernels
                     + window_kernels + bigbird_kernels[:1]})
    timed("pretrain_lang", pretrain_lang_phase, dev, smi)
    timed("gpt", gpt_phase, dev, smi)
    # the secondary models and tools: the serving and Grad-CAM calls' and
    # the domain-specific training step's own kernel numbers
    variants_kernels = timed("variants", variants_phase, dev, smi)
    # data-parallel training: K11-K13 split at their moments in two gloo
    # processes (the numbers of its kernel step, the launches of its
    # 2-process train_segment run)
    dp_kernels = timed("data_parallel", data_parallel_phase, dev, smi)
    # the dataset kit on the host
    timed("datasetkit", datasetkit_phase, smi)
    native_kernels = [dict(k, launches=native_launches[k["name"]],
                           path="ChapterPipeline, native decode")
                      for k in kernels] if native_launches else []
    print(json.dumps({"kernels": kernels + infer_kernels + bigbird_kernels
                      + train_kernels + window_kernels + int8_s2_kernels
                      + [chain_kernel] + vision_kernels + [title_kernel]
                      + eval_kernels + parallel_kernels
                      + native_kernels + variants_kernels + dp_kernels
                      + hf_kernels}))
    print(f"# phase seconds {json.dumps(laps)}; chip_smoke wall time "
          f"{time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k10_routes(sa, q, k, v, mask, b, l):
    """The ring and the mma.sync kernels (and the serving one where it
    applies) at each class of K10_ROUTE_BS x K10_ROUTE_HD, P 8 (3 random
    blocks), on the first B L H hd elements of q, k and v (H 1024 // hd):
    {class: {kernel: device ms (median of 5 from one torch.profiler
    trace), "route": the kernel the shape's route takes}}. Each kernel is
    forced through sa._launch, so the route can be checked against the
    times it was chosen from."""
    import torch

    from video_chapter_generation_tpu_torch.models.sparse_attention import (
        _tables,
    )

    runs, cells = [], {}
    for bs in K10_ROUTE_BS:
        tabs = _tables(l // bs, 3, 0, None, q.device)
        np_ = int(tabs[0].shape[1])
        for hd in K10_ROUTE_HD:
            h = 1024 // hd
            qr, kr, vr = [t.reshape(-1)[:b * l * h * hd].view(b, l, h, hd)
                          for t in (q, k, v)]
            res = torch.empty_like(qr)
            route = sa._route(bs, hd, np_, l // bs - 2)
            cell = cells[f"bs {bs} hd {hd}"] = {"route": sa.ROUTES[route]}
            for r in sorted({route, 1, 2}):
                fn = (lambda qr=qr, kr=kr, vr=vr, tabs=tabs, bs=bs, res=res,
                      r=r: sa._launch(qr[:, bs:l - bs], kr, vr, mask, *tabs,
                                      bs, res, r))
                runs.append((cell, sa.ROUTES[r], fn))
    reps = 5
    segs = traced_segments([fn for _, _, fn in runs] * reps)
    if len(segs) < reps * len(runs):
        return f"not measured: {len(segs)} runs traced for {reps * len(runs)}"
    for i, (cell, name, _) in enumerate(runs):
        times = sorted(sum(e.time_range.elapsed_us() for e in segs[i + j *
                                                                   len(runs)])
                       / 1e3 for j in range(reps))
        cell[name] = times[reps // 2]
    return cells


def time_kernels(root: Path) -> int:
    """K1, K8, K9, K14a and K14b at the shapes of one 256-frame vision
    call, K6 on its frames, K11 at one training step's (128 frames), K10
    at the BigBird-Pegasus serving shape and at K10_OTHER_SHAPES (and, on
    a tree whose K10 kernels can be forced, each of them at each class of
    K10_ROUTE_BS x K10_ROUTE_HD: k10_routes), and the pool kernel at
    [256, 112, 112, 64], on the package under root, CUDA events (median of
    TIMED_RUNS), beside their yardsticks: the stems' cuDNN sequence, the
    bf16 K2/K3 (K9) and K4 (K14a) launches of the same blocks, K11's cuDNN
    sequence through autograd, SDPA with K10's float mask, torch.addcmul
    for K6, the pool's torch sequence; K9's device time by conv and layer,
    K11's by pass, K6's, K14b's, K10's (by shape) and the pool's from
    torch.profiler traces. Seeded
    random ResNet-50 weights (the JAX layout carried over), frames and
    attention inputs. Prints one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import video_chapter_generation_tpu_torch.models.resnet as port_resnet
    from video_chapter_generation_tpu_torch.models import convert
    from video_chapter_generation_tpu_torch.models.resnet import (
        STAGE_SIZES,
        ResNet,
    )
    from video_chapter_generation_tpu_torch.ops import _build
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.quantize import (
        calibrate_resnet_quant,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        stem_frames,
        stem_s2d,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        int8_bottleneck,
        int8_s2_bottleneck,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev, bf = torch.device("cuda"), torch.bfloat16
    t0 = time.time()
    _build.build_all()
    built = time.time() - t0
    sizes = STAGE_SIZES[50]
    with torch.device("meta"):
        vision = ResNet(50, n_segment=CLIP_FRAMES, stem_input="s2d", dtype=bf)
    tree = convert.random_jax_tree(vision, convert.resnet_entries(sizes),
                                   seed=SEED)
    vision.load_state_dict(convert.from_jax_resnet(tree, sizes), assign=True)
    vision.to(dev).eval()
    with torch.device("meta"):
        vf = ResNet(50, n_segment=CLIP_FRAMES, stem_input="frames", dtype=bf)
    vf.load_state_dict(vision.state_dict(), assign=True)
    vf.eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = torch.randint(0, 256, (16 * CLIP_FRAMES, 56, 56, 48),
                           generator=gen, device=dev, dtype=torch.uint8)
    x_in = normalize_frames(depth_to_space4(frames), bf).contiguous()
    stem_p, block_ps = vision.folded_params()
    sargs = (stem_p["w7"], stem_p["s"], stem_p["b"])
    out = {"tree": str(root), "device": smi, "build_s": built,
           "K1": cuda_ms(lambda: stem_s2d(frames, *sargs)),
           "K8": cuda_ms(lambda: stem_frames(x_in, *sargs)),
           "stem_cudnn": cuda_ms(library_stem(x_in, *sargs))}
    try:
        out["K1_parts"] = stem_parts(frames, *sargs)
    except Exception as exc:  # information only
        out["K1_parts"] = f"not measured ({type(exc).__name__}: {exc})"

    # K9: the inference CLI's W8A8 trunk on the frames stem
    vq = vf.quantized(calibrate_resnet_quant(vf, x_in))
    plan, qps = vq._quant_plan(None), vq.quant_params()
    layer_of = [k + 1 for k, nb in enumerate(sizes) for _ in range(nb)]
    y = yb = stem_frames(x_in, *sargs)
    k9 = bf16 = 0.0
    runs = []
    for i, (blk, p) in enumerate(zip(vf.blocks(), block_ps)):
        if plan[i] is None:
            y = yb = blk.run(y, p, CLIP_FRAMES, 8)
            continue
        kernel = (lambda y=y, q=qps[i], mode=plan[i]: int8_bottleneck(
            y, q, CLIP_FRAMES, 8, mode, bf))
        k9 += cuda_ms(kernel)
        bf16 += cuda_ms(lambda yb=yb, blk=blk, p=p: blk.run(
            yb, p, CLIP_FRAMES, 8))
        runs.append((f"layer{layer_of[i]}", False, kernel))
        y, yb = kernel(), blk.run(yb, p, CLIP_FRAMES, 8)
    out.update({"K9": k9, "K9_blocks": len(runs),
                "K2K3_same_blocks": bf16})
    try:
        out["K9_split"] = serving_split(runs, by_name=True)
    except Exception as exc:  # information only
        out["K9_split"] = f"not measured ({type(exc).__name__}: {exc})"
    del runs, vq, qps

    # K14a: the s2d serving trunk with INT8_S2_BLOCKS
    old = port_resnet.INT8_S2_BLOCKS
    port_resnet.INT8_S2_BLOCKS = True
    try:
        vq = vision.quantized(calibrate_resnet_quant(vision, frames))
        plan = vq._quant_plan(None, (56, 56))
        qps = vq.quant_params(plan)
        y = yb = stem_s2d(frames, *sargs)
        k14 = k4 = 0.0
        for i, (blk, p) in enumerate(zip(vision.blocks(), block_ps)):
            if plan[i] == "s2":
                k14 += cuda_ms(lambda y=y, q=qps[i]: int8_s2_bottleneck(
                    y, q, CLIP_FRAMES, 8, "i8"))
                k4 += cuda_ms(lambda yb=yb, blk=blk, p=p: blk.run(
                    yb, p, CLIP_FRAMES, 8))
                y = int8_s2_bottleneck(y, qps[i], CLIP_FRAMES, 8, "i8")
            elif plan[i] is None:
                y = blk.run(y, p, CLIP_FRAMES, 8)
            else:
                y = int8_bottleneck(y, qps[i], CLIP_FRAMES, 8, plan[i], bf)
            yb = blk.run(yb, p, CLIP_FRAMES, 8)
    finally:
        port_resnet.INT8_S2_BLOCKS = old
    out.update({"K14a": k14, "K4_same_blocks": k4})
    del vq, qps

    # K14b on the same frames as K1 above; K6 on the frames of one 16-clip
    # call to bf16 (the main path's) and float32, beside torch.addcmul
    from video_chapter_generation_tpu_torch.models.resnet import _hwio
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        affine_consts,
    )
    from video_chapter_generation_tpu_torch.ops.stem import (
        stem_int8,
        stem_int8_weights,
    )

    sw = stem_int8_weights(_hwio(vision.conv1, torch.float32), stem_p["s"],
                           stem_p["b"])
    k14b = lambda: stem_int8(frames, sw)  # noqa: E731
    u8 = depth_to_space4(frames).reshape(16, CLIP_FRAMES, 224, 224, 3)
    u8 = u8.contiguous()
    a3, b3 = affine_consts(dev)
    k6 = lambda: normalize_frames(u8, bf)  # noqa: E731
    out.update({"K14b": cuda_ms(k14b), "K6": cuda_ms(k6),
                "K6_f32": cuda_ms(lambda: normalize_frames(u8,
                                                           torch.float32)),
                "K6_addcmul": cuda_ms(lambda: torch.addcmul(b3, u8, a3))})
    try:  # the device time of their launches, without the host's
        out["K14b_K6_split"] = pass_split([("K14b", k14b), ("K6", k6)])
    except Exception as exc:  # information only
        out["K14b_K6_split"] = f"not measured ({type(exc).__name__}: {exc})"
    del u8

    # K11: the training stem at one step's shape, through its two entries,
    # beside its cuDNN sequence; its device time by pass
    import numpy as np

    from video_chapter_generation_tpu_torch.models.seq2seq import (
        Seq2SeqConfig,
    )
    from video_chapter_generation_tpu_torch.models.sparse_attention import (
        _tables,
    )
    from video_chapter_generation_tpu_torch.ops import stem_train as k11
    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
    )

    x0 = frames[:TRAIN_CLIPS * CLIP_FRAMES].contiguous()
    w7 = vision.conv1.weight.permute(2, 3, 1, 0).detach()
    gamma, beta = vision.bn1.weight.detach(), vision.bn1.bias.detach()
    gb = torch.cat([gamma, beta]).float()
    wk = k11._stem_weight(w7)
    dy = torch.randn(*x0.shape[:3], 64, generator=gen, device=dev).to(bf)
    saved = k11.stem_train_fwd(x0, wk, gb, 1e-5)
    fwd = lambda: k11.stem_train_fwd(x0, wk, gb, 1e-5)  # noqa: E731
    bwd = lambda: k11.stem_train_bwd(  # noqa: E731
        dy, saved[0], saved[1], x0, gb, saved[2], saved[3], 1e-5)
    lib_f, lib_b = library_stem_train(
        normalize_frames(depth_to_space4(x0), bf), w7, gamma, beta, dy)
    out.update({"K11_fwd": cuda_ms(fwd), "K11_bwd": cuda_ms(bwd),
                "K11_cudnn_fwd": cuda_ms(lib_f),
                "K11_cudnn_bwd": cuda_ms(lib_b)})
    try:
        out["K11_split"] = pass_split([("fwd", fwd), ("bwd", bwd)])
    except Exception as exc:  # information only
        out["K11_split"] = f"not measured ({type(exc).__name__}: {exc})"
    del saved, lib_f, lib_b

    # K10 at the BigBird-Pegasus serving shape (seeded random q, k, v;
    # rows valid for 300..3072 tokens), beside SDPA with the float mask
    cfg = Seq2SeqConfig.bigbird_pegasus_large()
    b, l, bs = BIGBIRD_BATCH, BIGBIRD_IN, cfg.block_size
    h, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    q, k, v = [torch.randn(b, l, h, hd, generator=gen, device=dev).to(bf)
               for _ in range(3)]
    lens = torch.from_numpy(np.linspace(BIGBIRD_MIN_LEN, l, b).astype(int))
    mask = (torch.arange(l, device=dev)[None]
            < lens.to(dev)[:, None]).to(torch.int32)
    tabs = _tables(l // bs, cfg.num_rand_blocks, 0, None, dev)
    res = torch.empty_like(q)
    library, _ = sdpa_yardstick(q[:, bs:l - bs], k, v, mask, tabs, bs)
    k10 = lambda: sparse_band_attention(  # noqa: E731
        q[:, bs:l - bs], k, v, mask, *tabs, bs, res)
    out.update({"K10": cuda_ms(k10), "K10_sdpa": cuda_ms(library)})
    k10_runs = [("K10", k10)]
    del library
    # K10 at its other held shapes (phase 6's), the same bytes
    for label, bsr, heads, r in K10_OTHER_SHAPES:
        hdr = h * hd // heads
        qr, kr, vr = [t.reshape(b, l, heads, hdr) for t in (q, k, v)]
        tabs_r = _tables(l // bsr, r, 0, None, dev)
        fn = (lambda qr=qr, kr=kr, vr=vr, tabs_r=tabs_r, bsr=bsr,
              out_r=res.view(b, l, heads, hdr):
              sparse_band_attention(qr[:, bsr:l - bsr], kr, vr, mask,
                                    *tabs_r, bsr, out_r))
        out[f"K10 {label}"] = cuda_ms(fn)
        k10_runs.append((f"K10 {label}", fn))
    from video_chapter_generation_tpu_torch.ops import sparse_attention as sa
    if hasattr(sa, "_launch"):  # a tree whose kernels can be forced
        try:
            out["K10_routes"] = k10_routes(sa, q, k, v, mask, b, l)
        except Exception as exc:  # information only
            out["K10_routes"] = f"not measured ({type(exc).__name__}: {exc})"
    try:  # the device time of its launches, without the host's
        out["K10_split"] = pass_split(k10_runs)
    except Exception as exc:  # information only
        out["K10_split"] = f"not measured ({type(exc).__name__}: {exc})"
    del q, k, v, res, k10_runs
    torch.cuda.empty_cache()

    # the pool kernel at its held shape (the frames stem's conv output
    # [256, 112, 112, 64]; here seeded random values of that size), beside
    # its torch sequence
    from video_chapter_generation_tpu_torch.ops.stem import bn_relu_maxpool

    conv = torch.randn(16 * CLIP_FRAMES, 112, 112, 64, generator=gen,
                       device=dev).to(bf)
    pool = lambda: bn_relu_maxpool(conv, stem_p["s"], stem_p["b"])  # noqa
    out.update({"K8_pool": cuda_ms(pool),
                "K8_pool_library": cuda_ms(library_pool(conv, stem_p["s"],
                                                        stem_p["b"]))})
    try:
        out["K8_pool_split"] = pass_split([("K8_pool", pool)])
    except Exception as exc:  # information only
        out["K8_pool_split"] = f"not measured ({type(exc).__name__}: {exc})"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-kernels"]:
        sys.exit(dp_rank_kernels())
    if sys.argv[1:2] == ["--dp-train"]:
        sys.exit(dp_rank_train(sys.argv[2:]))
    if "--time-kernels" in sys.argv[1:]:
        args = sys.argv[1:]
        sys.exit(time_kernels(Path(args[args.index("--root") + 1]).resolve()
                              if "--root" in args else ROOT))
    sys.exit(main())
