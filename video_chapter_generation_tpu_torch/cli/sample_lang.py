"""Sample continuations from a pretrained subtitle language model on the
port (counterpart of the JAX package's cli/sample_lang.py:1-176).

    python -m video_chapter_generation_tpu_torch.cli.sample_lang \
        data.data_file=... data.subtitle_dir=... data.train_vid_file=... \
        train.ckpt_dir=... --task next_token_gpt|next_token_glove|next_token \
        [--glove emb.txt|emb.pkl] [--glove_vocab words.txt] \
        [--bert_vocab vocab.txt] [--prompt "let's get cooking the first"] \
        [--num_samples 2] [--temperature 1.0] [--top_k 10] \
        [--max_new_tokens 20] [--greedy] [--tiny] [--device cpu]

Runs on the card unless --device says otherwise. The model is the
checkpoint of the task's kind in train.ckpt_dir (cli/pretrain_lang's,
restored through cli/eval_title._restore, its contract checked), else
seeded random weights (a line says which), in model.compute_dtype.
--task next_token_gpt samples the from-scratch word-level GPT
(models/gpt.py:gpt_generate, the whole context re-run a token);
next_token_glove samples a vocabulary id and feeds that word's GloVe
row back (the reference's token_embedding_sample loop); next_token
samples BERT's next-token head, one full re-forward a token. Each
--prompt (repeatable; two seed sentences by default) is sampled
--num_samples times, top-k filtered, at --temperature, or greedily with
--greedy; draws come from one torch.Generator seeded with train.seed, so
two runs with the same seed sample the same ids. Prints
`prompt * continuation` a sample and returns the samples.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from ..core.contract import vocab_hash
from ..datasetkit.parsing import text_decontracted
from ..device import resolve_device
from ..models.gpt import gpt_generate, sample_next
from ..train.tasks import (
    GptGlovePretrainTask,
    GptPretrainTask,
    LangPretrainTask,
    compute_dtype,
)
from .common import load_bert_tokenizer, load_corpus, parse_config, pop_flag
from .eval_title import _restore
from .pretrain_lang import load_glove, load_word_vocab

# the reference's self-defined seed sentences (test_gpt.py:94)
DEFAULT_PROMPTS = [
    "let's get cooking the first",
    "so the first game of the day",
]
TASKS = ("next_token_gpt", "next_token_glove", "next_token")


def main(argv=None) -> List[Dict]:
    """Returns one {"prompt", "ids", "text"} a sample, in print order."""
    argv = list(argv if argv is not None else sys.argv[1:])
    task_name = pop_flag(argv, "--task") or "next_token_gpt"
    glove_path = pop_flag(argv, "--glove")
    glove_vocab = pop_flag(argv, "--glove_vocab")
    num_samples = int(pop_flag(argv, "--num_samples") or 2)
    temperature = float(pop_flag(argv, "--temperature") or 1.0)
    top_k = int(pop_flag(argv, "--top_k") or 10)
    max_new_tokens = int(pop_flag(argv, "--max_new_tokens") or 20)
    sample = pop_flag(argv, "--greedy", value=False) is None
    prompts = []
    while "--prompt" in argv:
        prompts.append(pop_flag(argv, "--prompt"))
    prompts = prompts or DEFAULT_PROMPTS
    if task_name not in TASKS:
        raise SystemExit(f"--task {task_name}: one of {', '.join(TASKS)}")
    if task_name == "next_token_glove" and not glove_path:
        raise SystemExit("--task next_token_glove needs --glove FILE")

    cfg, args = parse_config(argv, "sample subtitle language model")
    dev = resolve_device(args.device)
    corpus = load_corpus(cfg, "train")
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.train.seed)
    out: List[Dict] = []

    def restored(task, hashed):
        task.contract = dict(task.contract, vocab_hash=vocab_hash(hashed))
        model = task.model
        model.load_state_dict(_restore(cfg, task), assign=True)
        return model.to(dev, compute_dtype(cfg)).eval()

    def emit(prompt: str, ids: List[int], text: str):
        print(prompt + " * " + text)
        out.append({"prompt": prompt, "ids": ids, "text": text})

    with torch.no_grad():
        if task_name == "next_token_gpt":
            vocab = load_word_vocab(glove_vocab, corpus)
            model = restored(GptPretrainTask(cfg, len(vocab),
                                             tiny=args.tiny), vocab)
            token2id = {t: i for i, t in enumerate(vocab)}
            for prompt in prompts:
                context = [w for w in text_decontracted(prompt).split(" ")
                           if w in token2id]
                if not context:
                    print(f"{prompt} * <no in-vocab prompt words>")
                    continue
                ids = torch.tensor([[token2id[w] for w in context]],
                                   device=dev)
                for _ in range(num_samples):
                    new = gpt_generate(
                        model, ids, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k, sample=sample,
                        generator=generator)[0].tolist()
                    emit(prompt, new, " ".join(vocab[i] for i in new))

        elif task_name == "next_token_glove":
            table = load_glove(glove_path)
            vocab = (load_word_vocab(glove_vocab, corpus) if glove_vocab
                     else sorted(table))
            emb_dim = len(next(iter(table.values())))
            model = restored(GptGlovePretrainTask(
                cfg, len(vocab), tiny=args.tiny, emb_dim=emb_dim), vocab)

            def word_emb(w):
                e = table.get(w)
                return (np.zeros(emb_dim, np.float32) if e is None
                        else np.asarray(e, np.float32))

            for prompt in prompts:
                context = [w for w in text_decontracted(prompt).split(" ")
                           if w]
                for _ in range(num_samples):
                    embs = [word_emb(w) for w in context]
                    new = []
                    for _step in range(max_new_tokens):
                        x = torch.from_numpy(np.stack(embs)[None]).to(dev)
                        nxt = int(sample_next(model(x), temperature, top_k,
                                              sample, generator)[0])
                        new.append(nxt)
                        embs.append(word_emb(vocab[nxt]))
                    emit(prompt, new, " ".join(vocab[i] for i in new))

        else:
            tokenizer = load_bert_tokenizer(args, corpus)
            model = restored(LangPretrainTask(cfg, tokenizer.vocab_size,
                                              tiny=args.tiny), tokenizer)
            for prompt in prompts:
                base = tokenizer.convert_tokens_to_ids(
                    tokenizer.tokenize(text_decontracted(prompt)))
                for _ in range(num_samples):
                    ids, new = list(base), []
                    for _step in range(max_new_tokens):
                        a = torch.tensor([ids], device=dev)
                        logits, _ = model(a, torch.ones_like(a))
                        nxt = int(sample_next(logits, temperature, top_k,
                                              sample, generator)[0])
                        ids.append(nxt)
                        new.append(nxt)
                    emit(prompt, new, tokenizer.decode(new))
    return out


if __name__ == "__main__":
    main()
