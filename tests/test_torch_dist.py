"""The port's process-level distribution (parallel/dist.py) and the
video fan-out (pipeline/sharded.py:run_videos_distributed), in two
spawned processes on gloo, on the CPU.

- initialize by address (tcp://localhost:<free port>) and from a
  launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
  LOCAL_RANK, LOCAL_WORLD_SIZE, as torchrun sets them); a second call
  does nothing; the backend is gloo without a card.
- all_gather_object of objects of different pickled sizes, in rank
  order; broadcast_object from rank 1; barrier; an all_reduce.
- run_videos_distributed over 3 videos on a tiny text pipeline (seeded
  BERT weights, a synthetic corpus): each rank serves vids[rank::2] and
  both end with every video, in order, equal to one process's run.
- Without a group every function gives the single-process answer.

Each process has a timeout of 120 s, so a hang fails instead of holding
the suite.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from video_chapter_generation_tpu_torch.parallel import dist

ROOT = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent(r"""
    import json, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    from video_chapter_generation_tpu_torch.parallel import dist

    rank, mode = int(sys.argv[1]), sys.argv[2]
    if mode == "address":
        made = dist.initialize("localhost:{port}", num_processes=2,
                               process_id=rank)
    else:
        made = dist.initialize()
    assert made and not dist.initialize(), "a second call does nothing"
    assert dist.backend() == "gloo", dist.backend()
    assert (dist.process_index(), dist.process_count()) == (rank, 2)
    assert dist.is_primary() == (rank == 0)
    assert dist.local_rank() == rank and dist.local_count() == 2

    obj = {{"rank": rank, "blob": "x" * (10 + 5000 * rank)}}
    got = dist.all_gather_object(obj)
    assert [g["rank"] for g in got] == [0, 1]
    assert [len(g["blob"]) for g in got] == [10, 5010]
    root_obj = dist.broadcast_object(["from one", rank] if rank == 1
                                     else None, root=1)
    assert root_obj == ["from one", 1], root_obj
    dist.barrier("after broadcast")
    t = torch.tensor([rank + 1.0, 10.0 * rank])
    tdist.all_reduce(t)
    assert t.tolist() == [3.0, 10.0], t

    if mode == "env":
        from video_chapter_generation_tpu_torch.data.corpus import (
            VideoCorpus)
        from video_chapter_generation_tpu_torch.data.tokenization import (
            WordPieceTokenizer)
        from video_chapter_generation_tpu_torch.models import convert
        from video_chapter_generation_tpu_torch.models.bert import (
            BertConfig, BertForChapter)
        from video_chapter_generation_tpu_torch.pipeline import (
            ChapterPipeline, make_text_score_fn, run_videos_distributed)

        paths = json.loads({paths!r})
        corpus = VideoCorpus.from_files(paths["img_dir"],
                                        paths["data_file"],
                                        paths["train_vid_file"],
                                        paths["subtitle_dir"])
        tok = WordPieceTokenizer.build_from_corpus(
            [s["text"] for v in corpus.vids for s in corpus.subtitles(v)],
            vocab_size=200)
        with torch.device("meta"):
            net = BertForChapter(BertConfig.tiny(tok.vocab_size),
                                 pretrain_stage=False)
        entries = convert.bert_for_chapter_entries(2)
        net.load_state_dict(convert.from_jax(convert.random_jax_tree(
            net, entries, seed=3), entries), assign=True)
        cpu = torch.device("cpu")
        pipe = ChapterPipeline(
            corpus, tok, make_text_score_fn(net.eval(), cpu),
            lambda i, m: np.zeros((i.shape[0], 2), np.int32),
            decode_fn=lambda row: "t", score_mode="text", max_text_len=16,
            title_input_len=16, batch_size=4, device=cpu)
        served = []
        run = pipe.run
        pipe.run = lambda vids, **kw: served.extend(vids) or run(vids, **kw)
        out = run_videos_distributed(pipe, pipelined=False)
        assert served == corpus.vids[rank::2], served
        pipe.run = run
        alone = pipe.run(corpus.vids)
        assert list(out) == corpus.vids, list(out)
        for vid in corpus.vids:
            assert out[vid].clip_scores == alone[vid].clip_scores
            assert out[vid].cut_points == alone[vid].cut_points
        print(f"rank {{rank}} served {{served}}")
    dist.shutdown()
    print(f"rank {{rank}} {{mode}} OK")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus_paths(tmp_path_factory):
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )

    return make_synth_corpus_on_disk(
        str(tmp_path_factory.mktemp("dist_corpus")), n_videos=3,
        video_sec=40, hw=32, splits={"train": 3})


@pytest.mark.parametrize("mode", ["address", "env"])
def test_two_processes_on_gloo(mode, corpus_paths):
    import json

    port = _free_port()
    script = _WORKER.format(root=str(ROOT), port=port,
                            paths=json.dumps(corpus_paths))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_"))}
    procs = []
    for rank in (0, 1):
        env = dict(base, CUDA_VISIBLE_DEVICES="")
        if mode == "env":
            env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(rank), mode],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=ROOT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank} {mode} OK" in out, out
    if mode == "env":
        assert "rank 0 served ['synthvid000', 'synthvid002']" in outs[0]
        assert "rank 1 served ['synthvid001']" in outs[1]


def test_single_process_answers():
    assert not dist.initialize()  # no address, no launcher environment
    assert dist.process_index() == 0 and dist.process_count() == 1
    assert dist.is_primary() and dist.backend() is None
    assert dist.choose_backend(1) == "gloo"  # no card here
    assert dist.all_gather_object({"a": 1}) == [{"a": 1}]
    assert dist.broadcast_object(5) == 5
    dist.barrier("alone")
    dist.shutdown()
    with pytest.raises(ValueError, match="num_processes"):
        dist.initialize("localhost:1")
