"""MINE / CLUB mutual-information estimators (port of
``etts/models/mine.py``).

MINE bounds the MI of an embedding pair from below with the KL
(Donsker-Varadhan) or the Rényi-β divergence, EMA-smoothing its
exponential terms (`etts/models/mine.py:46-93`); CLUB bounds it from above
through a Gaussian conditional (`:175-205`). Joint pairs concatenate one
random character of the text encoding with the style and/or speaker
embeddings; marginal pairs shuffle the text and the speaker across the batch
(`:106-130`). The random draws (``pair_draws``) are apart from the
arithmetic (``build_pairs``), so a test can inject them. The carried state
is an explicit ``MIState``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
import torch.nn as nn

from .layers import (CLUBNet, MineNetFirstOrder, MineNetLinear,
                     MineNetLinearQ, MineNetSecondOrder)

__all__ = ["PAIR_TYPES", "MIState", "measure_mi", "PairDraws", "pair_draws",
           "build_pairs", "MINE", "CLUB"]

PAIR_TYPES = ("style_text", "style_speaker", "text_speaker",
              "style_text_speaker")


@dataclasses.dataclass
class MIState:
    """The carried MI state (etts' ``MIState``): the smoothed exponential
    terms (n_beta, 2), the last total MI estimate, and two constants."""
    exp_terms: torch.Tensor
    mi_loss: torch.Tensor
    smoothing_factor: float = 1.0
    weight_factor: float = 0.1

    @classmethod
    def create(cls, n_beta: int, smoothing_factor: float = 1.0,
               weight_factor: float = 0.1, device=None):
        return cls(torch.ones(max(n_beta, 1), 2, device=device),
                   torch.zeros((), device=device), smoothing_factor,
                   weight_factor)

    def state_dict(self) -> dict:
        return {"exp_terms": self.exp_terms, "mi_loss": self.mi_loss}

    def load_state_dict(self, d: dict):
        self.exp_terms = d["exp_terms"].to(self.exp_terms.device)
        self.mi_loss = d["mi_loss"].to(self.mi_loss.device)


def measure_mi(joint, marginal, exp_terms, smoothing_factor: float,
               divergence_type: str, beta_values: Sequence[float]):
    """The KL or Rényi-β MI lower bound of critic outputs on joint and
    marginal pairs, the exponential terms blended with the carried ones by
    ``smoothing_factor`` and stabilised by max-subtraction
    (`etts/models/mine.py:46-93`). Returns (mi, new exp_terms)."""
    curr, prev = smoothing_factor, 1.0 - smoothing_factor
    joint, marginal = joint.float(), marginal.float()
    zero = joint.new_zeros(())
    if divergence_type == "KL":
        t2 = curr * marginal.exp().mean() + prev * exp_terms[0, 1]
        new = exp_terms.clone()
        new[0] = torch.stack([zero, t2])
        return joint.mean() - t2.log(), new
    if divergence_type != "reyni":
        raise ValueError("divergence_type must be KL|reyni, got "
                         f"{divergence_type}")
    mi, rows = zero, []
    for i, beta in enumerate(beta_values):
        p1, p2 = exp_terms[i, 0], exp_terms[i, 1]
        t1 = t2 = zero
        if beta == 1:
            term2 = marginal.mean()
        else:
            max2 = ((1 - beta) * marginal).max()
            t2 = (curr * ((1 - beta) * marginal - max2).exp().mean()
                  + prev * p2)
            term2 = (1.0 / (1 - beta)) * (t2.log() + max2)
        if beta == 0:
            term1 = joint.mean()
        else:
            max1 = (-beta * joint).max()
            t1 = curr * (-beta * joint - max1).exp().mean() + prev * p1
            term1 = -(1.0 / beta) * (t1.log() + max1)
        mi = mi + (term1 - term2)
        rows.append(torch.stack([t1, t2]))
    return mi, torch.stack(rows)


class PairDraws(NamedTuple):
    """The random part of a pair: the character position (a 1-element
    tensor), the batch permutations of the text and of the speaker."""
    char: torch.Tensor
    text_perm: torch.Tensor
    speaker_perm: torch.Tensor


def pair_draws(batch: int, n_chars: int, generator: torch.Generator):
    """Draw one ``PairDraws`` on the generator's device (no host sync)."""
    dev = generator.device
    return PairDraws(
        torch.randint(n_chars, (1,), generator=generator, device=dev),
        torch.randperm(batch, generator=generator, device=dev),
        torch.randperm(batch, generator=generator, device=dev))


def _pick(text_embed, draws: PairDraws):
    """(b, n, d) -> ((b, 1, d) at the drawn character, that shuffled)."""
    text = text_embed.index_select(1, draws.char)
    return text, text[draws.text_perm]


def build_pairs(pair_type: str, text_embed, style_embed, speaker_embed,
                draws: PairDraws):
    """(joint, marginal) concatenations of ``pair_type``
    (`etts/models/mine.py:106-130`)."""
    text, text_shuf = _pick(text_embed, draws)
    spk_shuf = (None if speaker_embed is None
                else speaker_embed[draws.speaker_perm])
    parts = {"style_text": ([style_embed, text], [style_embed, text_shuf]),
             "style_speaker": ([style_embed, speaker_embed],
                               [style_embed, spk_shuf]),
             "text_speaker": ([text, speaker_embed], [text, spk_shuf]),
             "style_text_speaker": ([style_embed, text, speaker_embed],
                                    [style_embed, text_shuf, spk_shuf])}
    if pair_type not in parts:
        raise ValueError(f"pair_type {pair_type!r} not supported")
    joint, marginal = parts[pair_type]
    return torch.cat(joint, -1), torch.cat(marginal, -1)


def _pair_width(pair_type: str, text_dim: int, style_dim: int,
                spk_dim: int) -> int:
    widths = {"style": style_dim, "text": text_dim, "speaker": spk_dim}
    return sum(widths[p] for p in pair_type.split("_"))


def _at_params(net: nn.Module, *embeds):
    """The embeddings in the net's parameter dtype: the zoo stays float32
    under a bf16 TTS model, whose bf16 embeddings its Dense layers cast to
    float32, as etts builds the zoo with no dtype
    (`scripts/train_autoregressive.py:45, :54`)."""
    dt = next(net.parameters()).dtype
    return tuple(None if e is None else e.to(dt) for e in embeds)


class MINE(nn.Module):
    """MI lower bound over one embedding pair (`etts/models/mine.py:136-166`):
    the critic ``MineNet`` on the joint and the marginal pairs, then
    ``measure_mi``. ``text_dim``, ``style_dim`` and ``spk_dim`` are the
    embeddings' widths."""

    def __init__(self, pair_type: str, text_dim: int, style_dim: int,
                 spk_dim: int, divergence_type: str = "KL",
                 beta_values: Sequence[float] = (0.0, 0.5, 1.0),
                 dense_hidden_units: Sequence[int] = (512, 64),
                 conv_filters: Sequence[int] = (2,), conv_kernel: int = 5,
                 critic: str = "first_order"):
        super().__init__()
        self.pair_type = pair_type
        self.divergence_type = divergence_type
        self.beta_values = tuple(beta_values)
        width = _pair_width(pair_type, text_dim, style_dim, spk_dim)
        if critic == "second_order":
            # etts' pairs are one frame long, which its VALID convs refuse
            self.MineNet = MineNetSecondOrder(width, 1, conv_filters,
                                              conv_kernel, dense_hidden_units)
        else:
            critics = {"first_order": MineNetFirstOrder,
                       "linear": MineNetLinear, "linear_q": MineNetLinearQ}
            self.MineNet = critics[critic](width, dense_hidden_units)

    @property
    def n_beta(self) -> int:
        return len(self.beta_values) if self.divergence_type == "reyni" else 1

    def forward(self, text_embed, style_embed, speaker_embed, state: MIState,
                draws: PairDraws):
        """-> (mi, new exp_terms)."""
        text_embed, style_embed, speaker_embed = _at_params(
            self, text_embed, style_embed, speaker_embed)
        joint, marginal = build_pairs(self.pair_type, text_embed, style_embed,
                                      speaker_embed, draws)
        return measure_mi(self.MineNet(joint), self.MineNet(marginal),
                          state.exp_terms, state.smoothing_factor,
                          self.divergence_type, self.beta_values)


class CLUB(nn.Module):
    """Contrastive log-ratio upper bound of the MI of one pair
    (`etts/models/mine.py:169-205`): a Gaussian q(target | condition) with
    mean ``ClubNet_mu`` and log-variance ``ClubNet_log_var``. ``out_dim`` is
    the target's width. Returns (lld, bound): training maximises the
    log-likelihood ``lld``; ``bound`` is the MI upper bound."""

    def __init__(self, pair_type: str, text_dim: int, style_dim: int,
                 spk_dim: int, dense_hidden_units: Sequence[int] = (512, 64),
                 out_dim: int = 256):
        super().__init__()
        cond = {"style_text": style_dim, "style_speaker": style_dim,
                "text_speaker": text_dim}
        if pair_type not in cond:
            raise ValueError(f"pair_type {pair_type!r} not supported")
        self.pair_type = pair_type
        self.ClubNet_mu = CLUBNet(cond[pair_type], dense_hidden_units, False,
                                  out_dim)
        self.ClubNet_log_var = CLUBNet(cond[pair_type], dense_hidden_units,
                                       True, out_dim)

    def forward(self, text_embed, style_embed, speaker_embed, state: MIState,
                draws: PairDraws):
        text_embed, style_embed, speaker_embed = _at_params(
            self, text_embed, style_embed, speaker_embed)
        text, text_shuf = _pick(text_embed, draws)
        if self.pair_type == "style_text":
            cond, pos, neg = style_embed, text, text_shuf
        else:
            cond = style_embed if self.pair_type == "style_speaker" else text
            pos, neg = speaker_embed, speaker_embed[draws.speaker_perm]
        mu, log_var = self.ClubNet_mu(cond), self.ClubNet_log_var(cond)
        positive = -(mu - pos) ** 2 / 2.0 / log_var.exp()
        negative = -(mu - neg) ** 2 / 2.0 / log_var.exp()
        lld = positive.sum(-1).mean()
        bound = (positive.sum(-1) - negative.sum(-1)).mean()
        return lld, bound
