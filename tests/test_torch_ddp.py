"""Data-parallel training on the port (train/loop.py over a process group,
parallel/dist.py's moment group, parallel/loader.py, train/optim.py
:ZeroOptimizer), in spawned gloo processes on the CPU, float64, dropout
off.

- bn_train under a two-process moment group: output and input gradient
  equal one process's over the concatenated rows (1e-12), the gamma and
  beta gradients the sum of the processes'.
- The two-stream Trainer (BERT tiny, ResNet-TSM with one block per stage
  on 64-px s2d frames, as tests/test_torch_train.py), 2 processes
  against 1 on the same global batches of 4 clips, 2 updates with
  gradient_accumulation_steps=2 and ZeRO on: parameters, BN running
  averages and the (gathered) optimizer state equal at 1e-10 of each
  tensor's largest magnitude; the same run against the JAX Trainer on a
  (data 2, model 1) CPU mesh (tests/test_train_loop.py's counterpart)
  through from_jax's layouts at tests/test_torch_train.py's tolerance.
- ZeRO: each process's exp_avg is its slice along shard_params_zero's
  dim, entries under 2^14 elements whole, about half the state bytes;
  the 2-process checkpoint resumes in 1 process and its next update
  equals the uninterrupted 1-process run's.
- cli/train_title (tiny Pegasus) and cli/pretrain_lang --task mlm under
  a launcher's environment: 2 processes equal 1, at a checkpoint taken
  mid-cycle (the mean of the processes' .grad sums) and at one taken
  after an update.
- RankLoader: the processes' rows are the blocks of the global batch.

The processes of one case run at once, each with a 240 s timeout, so a
hang fails instead of holding the suite.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
T, B, L, HIDDEN, SIZES = 4, 4, 12, 16, (1, 1, 1, 1)
OCFG = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=1.0,
            warmup_epochs=1, final_epochs=4, lr_decay=True,
            lr_decay_type="cosine")

_WORKER = textwrap.dedent(r"""
    import dataclasses, json, os, sys, time
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from video_chapter_generation_tpu_torch.models import bert, seq2seq
    from video_chapter_generation_tpu_torch.parallel import dist

    # dropout off in every tiny model the CLIs build
    def _quiet(cls_tiny, **off):
        f = cls_tiny.__func__
        return classmethod(lambda cls, *a, **k: dataclasses.replace(
            f(cls, *a, **k), **off))
    bert.BertConfig.tiny = _quiet(bert.BertConfig.tiny, hidden_dropout=0.0,
                                  attention_dropout=0.0)
    seq2seq.Seq2SeqConfig.tiny = _quiet(seq2seq.Seq2SeqConfig.tiny,
                                        dropout=0.0)

    work, jobs = sys.argv[1], sys.argv[2].split(",")
    made = dist.initialize()
    rank, world = dist.process_index(), dist.process_count()
    tag = f"w{{world}}"
    ocfg = json.loads({ocfg!r})

    def bn_job():
        from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
            bn_train)
        d = np.load(os.path.join(work, "bn.npz"))
        per = d["v"].shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)
        v = torch.from_numpy(d["v"][rows]).requires_grad_()
        g = torch.from_numpy(d["gamma"]).requires_grad_()
        b = torch.from_numpy(d["beta"]).requires_grad_()
        mg = dist.MomentGroup(*dist.data_groups()[:2])
        with dist.use_moments(mg):
            out, mu, var = bn_train(v, g, b, 1e-5)
            (out * torch.from_numpy(d["up"][rows])).sum().backward()
        torch.save({{"out": out.detach(), "dv": v.grad, "dg": g.grad,
                    "db": b.grad, "mu": mu, "var": var}},
                   os.path.join(work, f"bn_{{rank}}.pt"))

    def segment_job(name, epochs, resume_from=None):
        from video_chapter_generation_tpu_torch.core.config import (
            Config, OptimConfig)
        from video_chapter_generation_tpu_torch.models.bert import BertConfig
        from video_chapter_generation_tpu_torch.train.loop import Trainer
        from video_chapter_generation_tpu_torch.train.tasks import SegmentTask
        d = np.load(os.path.join(work, "segment.npz"))
        ckpt = resume_from or os.path.join(work, f"seg_{{name}}")
        cfg = Config().apply_overrides(
            ["data.clip_frame_num={t}", "model.hidden_size={hidden}",
             "model.stem_input=s2d", "model.compute_dtype=float64",
             f"train.ckpt_dir={{ckpt}}",
             f"train.log_dir={{os.path.join(work, 'logs_' + name)}}",
             f"train.resume={{resume_from is not None}}",
             f"train.max_epochs={{epochs}}", "train.save_every_epochs=1"])
        cfg = cfg.replace(optim=OptimConfig(**ocfg,
                                            gradient_accumulation_steps=2))
        task = SegmentTask(cfg, tiny=True, bert_cfg=BertConfig.tiny())
        init = torch.load(os.path.join(work, "segment_init.pt"))
        task.init_state = lambda: dict(init)
        per = {b} // world

        def loader(epoch):
            for i in (2 * epoch, 2 * epoch + 1):
                yield {{k: d[k][i][rank * per:(rank + 1) * per]
                       for k in ("img_clip", "text_ids", "attention_mask",
                                 "label")}}

        trainer = Trainer(cfg, task, loader, device="cpu")
        trainer.train()
        if world > 1:
            st = trainer.opt.inner.state
            inner = [q for g in trainer.opt.inner.param_groups
                     for q in g["params"]]
            names = {{id(p): n for n, p in trainer.model.named_parameters()}}
            shapes = {{names[id(p)]: list(st[q]["exp_avg"].shape)
                      for (p, _), q in zip(trainer.opt.layout, inner)}}
            json.dump({{"shapes": shapes,
                       "bytes": trainer.opt.state_bytes()}},
                      open(os.path.join(work, f"zero_{{rank}}.json"), "w"))
        elif name == "one":
            json.dump({{"bytes": sum(
                t.numel() * t.element_size()
                for s in trainer.opt.state.values() for t in s.values()
                if torch.is_tensor(t))}},
                open(os.path.join(work, "zero_one.json"), "w"))

    def cli_job(name):
        from video_chapter_generation_tpu_torch.cli import (
            pretrain_lang, train_title)
        paths = json.load(open(os.path.join(work, "corpus.json")))
        argv = [f"data.{{k}}={{v}}" for k, v in paths.items()
                if k in ("img_dir", "data_file", "subtitle_dir",
                         "train_vid_file", "val_vid_file")]
        argv += ["model.compute_dtype=float64", "data.batch_size=4",
                 "train.max_epochs=2", "train.resume=false",
                 "train.eval_every_epochs=100",
                 "optim.gradient_accumulation_steps=2",
                 f"train.ckpt_dir={{os.path.join(work, name + '_' + tag)}}",
                 f"train.log_dir={{os.path.join(work, name + '_log_' + tag)}}",
                 "--tiny", "--device", "cpu"]
        if name == "title":
            train_title.main(argv + ["data.title_input_len=32",
                                     "data.title_decode_len=8"])
        else:
            pretrain_lang.main(argv + ["--task", "mlm",
                                       "data.max_text_len=16"])

    for job in jobs:
        if job == "bn":
            bn_job()
        elif job == "segment":
            segment_job(tag, 2)
        elif job == "segment_long":
            segment_job("one", 3)
        elif job == "resume":
            # the 2-process run's checkpoint of epoch 1, resumed alone
            src = os.path.join(work, "seg_w2")
            while not os.path.exists(os.path.join(work, "w2.done")):
                time.sleep(0.2)
            import shutil
            dst = os.path.join(work, "seg_resumed")
            shutil.copytree(src, dst)
            segment_job("resumed", 3, resume_from=dst)
        else:
            cli_job(job)
    if made:
        dist.barrier("done")
        dist.shutdown()
    if rank == 0:
        open(os.path.join(work, f"{{tag}}.done"), "w").close()
    print(f"rank {{rank}} of {{world}} OK", flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _spawn(script, work, jobs, world, port):
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_", "RANK", "WORLD_SIZE",
                                 "LOCAL_", "MASTER_"))}
    procs = []
    for rank in range(world):
        env = dict(base, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        if world > 1:
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(work), jobs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=ROOT))
    return procs


def _tree(seed):
    """tests/test_torch_train.py's seeded tiny TwoStream tree."""
    from video_chapter_generation_tpu_torch.models import convert
    from video_chapter_generation_tpu_torch.models.bert import (
        BertConfig, BertModel)
    from video_chapter_generation_tpu_torch.models.fusion import TwoStream
    from video_chapter_generation_tpu_torch.models.resnet import ResNet

    with torch.device("meta"):
        net = TwoStream(BertModel(BertConfig.tiny()),
                        ResNet(50, n_segment=T, stem_input="s2d",
                               stage_sizes=SIZES),
                        segment_size=T, hidden_size=HIDDEN)
    tree = convert.random_jax_tree(net, convert.two_stream_entries(2, SIZES),
                                   seed=seed)
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "var", "mean") or (k == "bias" and v.ndim):
                noise = rng.standard_normal(v.shape).astype(np.float32)
                node[k] = (np.abs(1 + 0.2 * noise) if k in ("scale", "var")
                           else 0.1 * noise)
    walk(tree)
    return tree


def _batches(rng, n):
    """n global batches of B clips: float s2d frames (already
    normalized), text, mask, labels."""
    out = {"img_clip": rng.standard_normal((n, B, T, 16, 16, 48)),
           "text_ids": rng.integers(1, 128, (n, B, L)).astype(np.int32),
           "attention_mask": np.ones((n, B, L), np.int32),
           "label": rng.integers(0, 2, (n, B)).astype(np.int32)}
    out["attention_mask"][:, 1::2, L - 3:] = 0
    return out


def _jax_trainer(work, tree, tmp_path):
    """The JAX Trainer on a (data 2, model 1) mesh of the CPU devices, the
    same weights, batches, optimizer and accumulation, float64 -> its
    final parameters and BN statistics in the port's layout."""
    import jax
    import jax.numpy as jnp

    import video_chapter_generation_tpu.models.resnet as jax_resnet
    from video_chapter_generation_tpu.core.config import (
        Config as JaxConfig,
        OptimConfig as JaxOptimConfig,
    )
    from video_chapter_generation_tpu.models.bert import (
        BertConfig as JaxBertConfig,
        BertModel as JaxBertModel,
    )
    from video_chapter_generation_tpu.models.fusion import (
        TwoStream as JaxTwoStream,
    )
    from video_chapter_generation_tpu.train.loop import Trainer as JaxTrainer
    from video_chapter_generation_tpu.train.objectives import (
        clip_classification_loss,
    )
    from video_chapter_generation_tpu_torch.models import convert

    d = np.load(work / "segment.npz")
    bcfg = dataclasses.replace(JaxBertConfig.tiny(), hidden_dropout=0.0,
                               attention_dropout=0.0)
    model = JaxTwoStream(
        lang_model=JaxBertModel(bcfg, dtype=jnp.float64),
        vision_model=jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T,
                                       stem_input="s2d", dtype=jnp.float64),
        segment_size=T, hidden_size=HIDDEN, head_type="mlp",
        dtype=jnp.float64)

    class Task:
        def init_variables(self):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), tree)

        def loss_fn(self, params, batch_stats, batch, rng):
            (logits, _), mut = model.apply(
                {"params": params, "batch_stats": batch_stats},
                batch["img_clip"], batch["text_ids"],
                batch["attention_mask"], deterministic=True, train=True,
                mutable=["batch_stats"])
            loss, metrics = clip_classification_loss(logits, batch["label"])
            return loss, (metrics, mut["batch_stats"])

    cfg = JaxConfig().apply_overrides([
        "mesh.data_axis=2", "mesh.model_axis=1", "mesh.shard_opt_state=true",
        "train.max_epochs=2", "train.save_every_epochs=100",
        f"train.ckpt_dir={tmp_path / 'ckpt'}",
        f"train.log_dir={tmp_path / 'logs'}", "train.resume=false"])
    cfg = dataclasses.replace(cfg, optim=JaxOptimConfig(
        **OCFG, gradient_accumulation_steps=2))

    def loader(epoch):
        for i in (2 * epoch, 2 * epoch + 1):
            yield {k: d[k][i] for k in ("img_clip", "text_ids",
                                        "attention_mask", "label")}

    with jax.enable_x64(True):
        trainer = JaxTrainer(cfg=cfg, task=Task(), train_loader=loader)
        assert trainer.mesh.shape["data"] == 2
        trainer.train()
        want = jax.device_get({"params": trainer.state.params,
                               "batch_stats": trainer.state.batch_stats})
    port = {}
    for path, key, kind in convert.two_stream_entries(2, SIZES):
        leaf = want
        for p in path:
            leaf = leaf[p]
        port[key] = torch.from_numpy(np.array(convert._to_torch_layout(
            np.asarray(leaf, np.float64), kind)))
    return {k: v for k, v in port.items()
            if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's processes: 2 gloo processes (bn, segment for 2
    epochs, title, mlm) beside 1 process (segment for 3 epochs, title,
    mlm, then the 2-process checkpoint resumed for its third epoch), and
    meanwhile the JAX Trainer here -> (work dir, tree, its state or the
    exception it raised)."""
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.models import convert

    work = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(7)
    np.savez(work / "bn.npz", v=rng.standard_normal((8, 3, 3, 6)),
             gamma=1 + 0.1 * rng.standard_normal(6),
             beta=0.1 * rng.standard_normal(6),
             up=rng.standard_normal((8, 3, 3, 6)))
    tree = _tree(41)
    np.savez(work / "segment.npz", **_batches(np.random.default_rng(42), 6))
    torch.save({k: v.double() if v.is_floating_point() else v
                for k, v in convert.from_jax_two_stream(tree, 2,
                                                        SIZES).items()},
               work / "segment_init.pt")
    paths = make_synth_corpus_on_disk(
        str(work / "corpus"), n_videos=13, video_sec=40, hw=32, seed=3,
        splits={"train": 12, "val": 1})
    (work / "corpus.json").write_text(json.dumps(paths))
    script = _WORKER.format(root=str(ROOT), ocfg=json.dumps(OCFG), t=T,
                            hidden=HIDDEN, b=B)
    port = _free_port()
    procs = (_spawn(script, work, "bn,segment,title,mlm", 2, port)
             + _spawn(script, work, "segment_long,title,mlm,resume", 1,
                      port))
    # the JAX Trainer runs while the processes do
    try:
        jax_state = _jax_trainer(work, tree, work / "jax")
    except Exception as exc:  # raised by its own test
        jax_state = exc
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    return work, tree, jax_state


def _ckpt(path, epoch):
    return torch.load(Path(path) / f"ckpt_{epoch}.pt",
                      weights_only=True)["state"]


def _close(got, want, rel, atol=0.0, what=""):
    for k in want:
        w = want[k].double() if torch.is_tensor(want[k]) else torch.tensor(
            np.asarray(want[k], np.float64))
        g = got[k].double()
        scale = max(float(w.abs().max()), 1e-30) if w.numel() else 0.0
        torch.testing.assert_close(g, w, rtol=0, atol=atol + rel * scale,
                                   msg=lambda m: f"{what} {k}: {m}")


def _same_state(a, b, rel=1e-10, atol=1e-14):
    """Model tensors (parameters and BN running averages) and optimizer
    state of two checkpoints' states."""
    _close(a["model"], {k: v for k, v in b["model"].items()
                        if v.is_floating_point()}, rel, atol, "model")
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb)
    for i in sb:
        _close({k: sa[i][k] for k in ("exp_avg", "exp_avg_sq")},
               {k: sb[i][k] for k in ("exp_avg", "exp_avg_sq")}, rel, atol,
               f"optimizer {i}")
        assert float(sa[i]["step"]) == float(sb[i]["step"])
    assert a["step"] == b["step"]
    assert sorted(a.get("grads", {})) == sorted(b.get("grads", {}))
    if "grads" in b:  # mid-cycle: the processes' mean of the .grad sums
        _close(a["grads"], b["grads"], rel, atol, "grads")


def test_bn_train_under_a_moment_group(runs):
    work = runs[0]
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        bn_train,
    )

    d = np.load(work / "bn.npz")
    v = torch.from_numpy(d["v"]).requires_grad_()
    g = torch.from_numpy(d["gamma"]).requires_grad_()
    b = torch.from_numpy(d["beta"]).requires_grad_()
    out, mu, var = bn_train(v, g, b, 1e-5)
    (out * torch.from_numpy(d["up"])).sum().backward()
    parts = [torch.load(work / f"bn_{r}.pt") for r in (0, 1)]
    for p in parts:
        torch.testing.assert_close(p["mu"], mu, rtol=0, atol=1e-12)
        torch.testing.assert_close(p["var"], var, rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.cat([p["out"] for p in parts]),
                               out.detach(), rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.cat([p["dv"] for p in parts]), v.grad,
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(parts[0]["dg"] + parts[1]["dg"], g.grad,
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(parts[0]["db"] + parts[1]["db"], b.grad,
                               rtol=0, atol=1e-12)


def test_segment_trainer_two_processes_equal_one(runs):
    work = runs[0]
    two, one = _ckpt(work / "seg_w2", 1), _ckpt(work / "seg_one", 1)
    _same_state(two, one)
    # the updates moved the weights and the running averages
    init = torch.load(work / "segment_init.pt")
    moved = [k for k, v in two["model"].items() if v.is_floating_point()
             and not torch.equal(v, init[k])]
    assert any("running_mean" in k for k in moved)
    assert any(k.endswith("conv1.weight") for k in moved)


def test_segment_trainer_matches_the_jax_trainer(runs):
    work, jax_state = runs[0], runs[2]
    if isinstance(jax_state, BaseException):
        raise jax_state
    _close(_ckpt(work / "seg_w2", 1)["model"], jax_state, 1e-7, 1e-10, "jax")


def test_zero_slices_follow_shard_params_zero(runs):
    from video_chapter_generation_tpu_torch.models.bert import BertConfig
    from video_chapter_generation_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_params_zero,
    )

    work = runs[0]
    init = torch.load(work / "segment_init.pt")
    from video_chapter_generation_tpu_torch.core.config import Config
    from video_chapter_generation_tpu_torch.train.tasks import SegmentTask

    task = SegmentTask(Config().apply_overrides(
        [f"data.clip_frame_num={T}", f"model.hidden_size={HIDDEN}",
         "model.stem_input=s2d"]), tiny=True, bert_cfg=BertConfig.tiny())
    shapes = {n: p.shape for n, p in task.model.named_parameters()}
    dims = shard_params_zero(make_mesh(data=2, devices=["cpu"] * 2),
                             {n: init[n] for n in shapes})
    sharded = [n for n, dim in dims.items() if dim is not None]
    assert sharded and len(sharded) < len(dims)
    for rank in (0, 1):
        got = json.loads((work / f"zero_{rank}.json").read_text())["shapes"]
        assert set(got) == set(shapes)
        for n, shape in shapes.items():
            want = list(shape)
            if dims[n] is not None:
                want[dims[n]] //= 2
            else:
                assert shape.numel() < 2 ** 14 or all(s % 2 for s in shape)
            assert got[n] == want, n
    one = json.loads((work / "zero_one.json").read_text())["bytes"]
    for rank in (0, 1):
        mine = json.loads((work / f"zero_{rank}.json").read_text())["bytes"]
        assert mine <= 0.55 * one, (mine, one)


def test_two_process_checkpoint_resumes_in_one(runs):
    work = runs[0]
    _same_state(_ckpt(work / "seg_resumed", 2), _ckpt(work / "seg_one", 2))


@pytest.mark.parametrize("name", ["title", "mlm"])
def test_cli_two_processes_equal_one(runs, name):
    """3 micro-steps an epoch with accumulation 2: epoch 0 ends mid-cycle
    (its checkpoint carries the .grad sums), epoch 1 on an update."""
    work = runs[0]
    for epoch in (0, 1):
        two = _ckpt(work / f"{name}_w2", epoch)
        _same_state(two, _ckpt(work / f"{name}_w1", epoch))
        assert ("grads" in two) == (epoch == 0)


def test_rank_loader_takes_blocks_of_the_global_batch():
    from video_chapter_generation_tpu_torch.data.loader import DataLoader
    from video_chapter_generation_tpu_torch.parallel.loader import (
        RankLoader,
        rank_loader,
    )

    class Rows:
        seen = []

        def __len__(self):
            return 21

        def __getitem__(self, i, epoch=0):
            Rows.seen.append(i)
            return {"i": np.asarray(i)}

    full = DataLoader(Rows(), 6, seed=5, prefetch=0)
    assert rank_loader(full, 0, 1) is full
    want = [b["i"] for b in full(1)]
    Rows.seen = []
    parts = [[b["i"] for b in RankLoader(full, r, 3)(1)] for r in range(3)]
    assert sorted(Rows.seen) == sorted(np.concatenate(want).tolist())
    for step, batch in enumerate(want):
        np.testing.assert_array_equal(
            np.concatenate([parts[r][step] for r in range(3)]), batch)
    with pytest.raises(ValueError, match="divisible"):
        RankLoader(full, 0, 4)
    with pytest.raises(ValueError, match="drops"):
        RankLoader(DataLoader(Rows(), 6, drop_last=False), 0, 2)
