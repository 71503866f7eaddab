"""Measure the disentanglement of trained AR models with FRESH critics (port
of ``scripts/eval_disentanglement.py``).

    python -m etts_torch.eval_disentanglement --config DIR \\
        --weights base.npz mine.npz [--steps 14000 14000] \\
        [--pairs style_text ...] [--critic_steps 600] [--batch_size 8] \\
        [--max_batches 16] [--seeds 3] [--probe_first_token] [--club] \\
        [--out mi.csv] [--device cuda|cpu]

The MI values a training run logs come from its own adversarially trained
critics, a moving yardstick. Here each model is frozen, its embeddings are
cached over the training store (``train_metafile.txt``, ``mels/``,
``spk_embeds/``), and per pair a FRESH MINE critic (``--club``: also a
CLUB critic) is trained from scratch on them (``models/mine.py``,
``train/steps.py::make_mine_update``); the reported bound is the mean of
its last max(50, steps / 5) estimates: MINE's KL lower bound, CLUB's upper
bound. ``--probe_first_token`` adds a linear softmax probe from the style
embedding to the first real token, trained full-batch by gradient descent
from zeros (its test accuracy beside the chance rate). Models are flat npz
exports (``--steps``: each one's training step, which sets r; 0 where
omitted), where etts takes sessions. One CSV row per model and pair.
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch


def cache_embeddings(config_dir, weights, step: int, batch_size: int,
                     max_batches: int, device):
    """Frozen-model embeddings over the training store: a list of (text
    encoding (b, n, d), GST output (b, 1, d), speaker input (b, 1, d), the
    zeros (b, 1, 1) without a speaker) numpy float32 batches, and each
    batch's first real token (position 1 where every row starts with the
    same start token)."""
    from .convert import load_into
    from .data.dataset import DataPrepper, Dataset, load_files
    from .text import default_tokenizer
    from .utils.config import build_tts, load_config, schedule_values
    config = load_config(config_dir, "autoregressive")
    tok = default_tokenizer(True)
    model = load_into(build_tts(config, tok.vocab_size), weights).to(device)
    datadir = Path(config.get("train_data_directory")
                   or config["data_directory"])
    samples, _ = load_files(datadir / "train_metafile.txt", datadir / "mels",
                            datadir / "spk_embeds" if model.has_speaker
                            else None)
    ds = Dataset(samples, DataPrepper(config, tok), batch_size,
                 mel_channels=config["mel_channels"], seed=7)
    r = schedule_values(config, step)["reduction_factor"]
    cached, labels = [], []
    with torch.no_grad():
        for _ in range(max_batches):
            mel, phon, _, spk = ds.next_batch()
            spk_in = (torch.from_numpy(spk)[:, None, :] if model.has_speaker
                      else torch.zeros(mel.shape[0], 1, 1))
            tar = torch.from_numpy(mel).to(device)[:, :-1][:, ::r]
            out = model.encode(torch.from_numpy(phon).long().to(device), tar,
                               spk_in.to(device))
            cached.append((out[6].float().cpu().numpy(),
                           out[5].float().cpu().numpy(),
                           spk_in.float().numpy()))
            pos = 1 if len(set(phon[:, 0])) == 1 else 0
            labels.append(phon[:, pos])
    return cached, labels


def fit_probe(x, y, n_classes: int, epochs: int = 400, device="cpu"):
    """Softmax regression of y on x (numpy), full-batch gradient descent at
    step 0.5 from zeros, an L2 penalty of 1e-3 on the kernel
    (`eval_disentanglement.py:77-111`). Returns (W (d, classes), b)."""
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, dtype=torch.long, device=device)
    W = torch.zeros(x.shape[1], n_classes, device=device, requires_grad=True)
    b = torch.zeros(n_classes, device=device, requires_grad=True)
    for _ in range(epochs):
        logp = torch.log_softmax(xt @ W + b, -1)
        loss = (-logp[torch.arange(len(yt), device=device), yt].mean()
                + 1e-3 * (W * W).sum())
        gW, gb = torch.autograd.grad(loss, (W, b))
        with torch.no_grad():
            W -= 0.5 * gW
            b -= 0.5 * gb
    return W.detach(), b.detach()


def probe_text_leakage(cached, labels, seed: int = 0, epochs: int = 400,
                       device="cpu"):
    """Linear probe: the first token from the STYLE embedding, on a seeded
    3:1 split, the features standardized by the training rows. Returns
    (test accuracy, chance rate: the most frequent training class's
    share)."""
    gst = np.concatenate([c[1][:, 0] for c in cached])
    classes, y = np.unique(np.concatenate(labels), return_inverse=True)
    order = np.random.default_rng(seed).permutation(len(y))
    n_tr = max(1, int(0.75 * len(y)))
    tr, te = order[:n_tr], order[n_tr:]
    x = (gst - gst[tr].mean(0)) / (gst[tr].std(0) + 1e-6)
    W, b = fit_probe(x[tr], y[tr], len(classes), epochs, device)
    pred = (torch.as_tensor(x[te], device=device) @ W + b).argmax(-1)
    counts = np.bincount(y[tr])
    return (float((pred.cpu().numpy() == y[te]).mean()),
            float(counts.max() / counts.sum()))


def fresh_critic(cached, pair: str, kind: str, seed: int, device):
    """A new MINE (KL) or CLUB critic for ``pair`` at the cached
    embeddings' widths, initialised as flax initialises etts' from
    ``seed``, with its ``TrainState`` (Adam at 1e-4) and ``MIState``."""
    from .models.init import init_flax
    from .models.mine import CLUB, MINE, MIState
    from .train.state import TrainState
    t0, g0, s0 = cached[0]
    dims = dict(text_dim=t0.shape[-1], style_dim=g0.shape[-1],
                spk_dim=s0.shape[-1])
    if kind == "CLUB":
        net = CLUB(pair, **dims, out_dim=(t0.shape[-1] if pair == "style_text"
                                          else s0.shape[-1]))
    else:
        net = MINE(pair, **dims, divergence_type="KL")
    net = init_flax(net, torch.Generator().manual_seed(seed)).to(device)
    return (net, TrainState(net, [[0, 1e-4]]),
            MIState.create(getattr(net, "n_beta", 1), device=device))


def train_fresh_critic(cached, pair: str, steps: int, seed: int = 0,
                       kind: str = "MINE", device="cpu") -> float:
    """Train a fresh critic on the frozen embeddings, a batch a step in
    turn; returns the mean of its last max(50, steps // 5) estimates."""
    from .train.steps import fold_in, make_mine_update
    net, state, mi_state = fresh_critic(cached, pair, kind, seed, device)
    update = make_mine_update(net, kind)
    batches = [tuple(torch.from_numpy(a).to(device) for a in c)
               for c in cached]
    tail = []
    for i in range(steps):
        mi, mi_state.exp_terms = update(state, *batches[i % len(batches)],
                                        mi_state, fold_in(seed, i))
        if i >= steps - max(50, steps // 5):
            tail.append(float(mi))
    return float(np.mean(tail))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--weights", nargs="+", required=True,
                        help="flat npz exports, one per model")
    parser.add_argument("--steps", type=int, nargs="*", default=None,
                        help="each export's training step (0 where omitted)")
    parser.add_argument("--pairs", nargs="*", default=["style_text"])
    parser.add_argument("--critic_steps", type=int, default=600)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_batches", type=int, default=16)
    parser.add_argument("--seeds", type=int, default=3,
                        help="fresh critics per pair (report mean and std)")
    parser.add_argument("--probe_first_token", action="store_true",
                        help="also report a linear style -> first-token "
                             "probe's accuracy (direct text leakage)")
    parser.add_argument("--club", action="store_true",
                        help="also train fresh CLUB critics: the MI upper "
                             "bound beside MINE's lower bound")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from .utils.precision import pin_float32
    pin_float32()
    device = torch.device(args.device)
    steps = list(args.steps or [])
    rows = []
    for i, weights in enumerate(args.weights):
        name = Path(weights).stem
        step = steps[i] if i < len(steps) else 0
        cached, labels = cache_embeddings(args.config, weights, step,
                                          args.batch_size, args.max_batches,
                                          device)
        if args.probe_first_token:
            accs = [probe_text_leakage(cached, labels, seed=s, device=device)
                    for s in range(args.seeds)]
            acc = float(np.mean([a for a, _ in accs]))
            rows.append(dict(session=name, step=step,
                             pair="probe_first_token", mi_mean=round(acc, 4),
                             mi_std=round(float(np.std([a for a, _ in accs])),
                                          4),
                             critics=args.seeds))
            print(f"{name}@{step} style->first-token linear probe: "
                  f"acc {acc:.3f} (chance {accs[0][1]:.3f})")
        for pair in args.pairs:
            for kind in ["MINE"] + (["CLUB"] if args.club else []):
                vals = [train_fresh_critic(cached, pair, args.critic_steps,
                                           seed=s, kind=kind, device=device)
                        for s in range(args.seeds)]
                row = dict(session=name, step=step,
                           pair=pair if kind == "MINE"
                           else f"{pair}:CLUB_upper",
                           mi_mean=round(float(np.mean(vals)), 4),
                           mi_std=round(float(np.std(vals)), 4),
                           critics=args.seeds)
                rows.append(row)
                bound = "lower" if kind == "MINE" else "UPPER"
                print(f"{name}@{step} {pair} [{kind} {bound} bound]: "
                      f"MI = {row['mi_mean']:.4f} ± {row['mi_std']:.4f} "
                      f"({args.seeds} fresh critics)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
