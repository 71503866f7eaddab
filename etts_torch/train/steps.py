"""Train and validation steps of the forward and autoregressive models,
the MINE zoo's updates, the WaveRNN vocoder's step and GST-Tacotron's
(port of ``etts/train/steps.py:50-449``).

The forward step: the masked MAE of the mel and of the durations, weights
3 and 1, the target durations regulating the lengths; no prenet dropout,
as etts passes none.

The joint TTS + MINE step, as the reference's `traning_steps.py`:
  - TTS loss = MAE(final) + stop cross-entropy (class 2 scaled by
    ``stop_scaling``) + MAE(mel_linear), weights 1, 1, 1;
  - an optional style-consistency loss: the predicted mel re-encoded
    through the style encoder, l2 against the first pass;
  - total = tts + weight * max(0, mi), where mi is the previous step's MI
    estimate, a constant under the tape; or, with ``adversarial_mine``, the
    zoo's estimate on this pass's embeddings, the critics held constant;
  - each MINE net climbs its own MI estimate (CLUB its log-likelihood).

Steps update their state in place and return metrics as tensors on the
device (no host sync). Under a process group of more than one rank each
train step is its rank's part of the global batch's step
(``parallel.collectives``): the batch holds the rank's rows, the
gradients are averaged over the ranks before the update, and the metrics
are the global batch's. Per-step randomness comes from generators seeded by
``fold_in(rng, stream)``, and the driver passes ``rng = fold_in(seed,
step)``, as etts folds its keys, so a resumed run draws what an
uninterrupted one draws.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from ..models.mine import MIState, pair_draws
from ..models.tacotron import tacotron_loss
from ..models.wavernn import discretized_mix_logistic_loss, raw_loss
from ..parallel import collectives
from ..utils.losses import (l2_loss, masked_mean_absolute_error,
                            new_scaled_crossentropy, weighted_sum_losses)
from ..utils.seeds import fold_in

__all__ = ["fold_in", "generator", "frozen_batch_stats",
           "make_forward_train_step", "make_forward_val_step",
           "make_autoregressive_train_step", "make_autoregressive_val_step",
           "make_mine_update", "make_mine_zoo_update",
           "make_wavernn_train_step", "make_tacotron_train_step"]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


@contextlib.contextmanager
def frozen_batch_stats(module: torch.nn.Module):
    """Run a pass whose BatchNorm running statistics are thrown away, as
    etts drops the ``batch_stats`` of its extra passes."""
    saved = [(b, b.clone()) for n, b in module.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def _grads(loss, params):
    """d loss / d params; zeros for a parameter the loss does not reach
    (as JAX gives); in a data-parallel step, their mean over the ranks."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return collectives.average_gradients(
        [torch.zeros_like(p) if g is None else g
         for p, g in zip(params, grads)])


def _forward_losses(model, batch, max_frames: int, train: bool, gen):
    """(out, loss, [mel loss, duration loss]) of the forward model on
    (mel, phonemes, durations)."""
    mel, phonemes, durations = batch
    durations = durations[..., None]
    out = model(phonemes, durations, max_frames=max_frames, train=train,
                generator=gen)
    loss, vals = weighted_sum_losses(
        (mel, durations), (out["mel"][:, :mel.shape[1]], out["duration"]),
        (masked_mean_absolute_error, masked_mean_absolute_error), (3.0, 1.0))
    return out, loss, vals


def _forward_metrics(loss, vals) -> dict:
    return {"loss": loss.detach(), "mel_loss": vals[0].detach(),
            "duration_loss": vals[1].detach()}


def make_forward_train_step(model, max_frames: int, mesh=None):
    """``step(state, batch, rng) -> metrics``, one Adam update of ``state``
    (a ``TrainState`` of the forward ``model``) on ``batch`` (mel,
    phonemes, durations) on the model's device, dropout drawn from
    ``generator(rng)`` (`etts/train/steps.py:50-86`). Metrics: {"loss",
    "mel_loss", "duration_loss"}. ``mesh``: a ("data", "model") mesh of a
    tensor-parallel ``model`` (``parallel.tp``), the batch the rank's rows
    of the data axis."""
    @functools.partial(collectives.sharded_step, mesh=mesh)
    def step(state, batch, rng: int):
        _, loss, vals = _forward_losses(model, batch, max_frames, True,
                                        generator(rng, batch[0].device))
        state.apply_gradients(_grads(loss, state.params))
        return collectives.global_mean(_forward_metrics(loss, vals))

    return step


def make_forward_val_step(model, max_frames: int):
    """``step(batch, rng) -> (metrics, out)``: the forward model with the
    train flags off (`etts/train/steps.py:89-103`); ``out`` is its dict."""
    @torch.no_grad()
    def step(batch, rng: int):
        out, loss, vals = _forward_losses(model, batch, max_frames, False,
                                          generator(rng, batch[0].device))
        return _forward_metrics(loss, vals), out

    return step


def _tts_losses(out, tar_real, tar_stop, mel_len, loss_fns):
    return weighted_sum_losses(
        (tar_real, tar_stop, tar_real),
        (out["final_output"][:, :mel_len], out["stop_prob"][:, :mel_len],
         out["mel_linear"][:, :mel_len]), loss_fns, (1.0, 1.0, 1.0))


def _loss_fns(stop_scaling: float):
    return (masked_mean_absolute_error,
            new_scaled_crossentropy(index=2, scaling=stop_scaling),
            masked_mean_absolute_error)


def make_autoregressive_train_step(model, *, stop_scaling: float = 8.0,
                                   use_style_loss: bool = False,
                                   mi_weight_factor: float = 0.1,
                                   train_text_encoder: bool = True,
                                   train_style_encoder: bool = True,
                                   train_decoder: bool = True,
                                   adversarial_mine=None,
                                   scheduled_sampling: bool = False,
                                   gta_inputs: bool = False, mesh=None):
    """``step(state, batch, mi_loss, rng, *, r, prenet_dropout=0.5,
    drop_n_heads=0, ss_rate=0.0) -> (metrics, aux)``, one Adam update of
    ``state`` (a ``TrainState`` of ``model``).

    ``batch``: (mel, phonemes, stop, spk[, gta_mel]) tensors on the model's
    device. ``mi_loss``: the previous step's MI estimate, or, with
    ``adversarial_mine`` (the driver's zoo of ``(kind, net)``), the
    ``MIState``. ``scheduled_sampling``: a first pass with the train flags
    off and no gradient predicts the frames; each r-strided decoder input is
    replaced by its prediction with probability ``ss_rate`` (the style
    encoder keeps the clean mel); ss_rate 0 is the plain step bit for bit.
    ``gta_inputs``: the decoder reads the batch's fifth tensor, a frozen
    checkpoint's teacher-forced mel (its GO frame exact), the targets and
    the style reference stay ground truth. Metrics: {"loss", "tts_loss",
    "style_loss", "mi_live", "losses": {"output", "stop_prob",
    "mel_linear"}}; aux: text_enc_output, gst_output (detached; the global
    batch's rows, which the zoo reads), decoder_attention, reduced_target,
    final_output (the rank's rows).

    ``mesh``: a ("data", "model") mesh of a tensor-parallel ``model``
    (``parallel.tp``), or a ("data", "seq") mesh: sequence parallelism,
    etts' ``seq_sharding`` P('data', 'seq', None) on the teacher-forcing
    mel, ``tar_real`` and ``tar_mel``. Each seq rank keeps its frames of
    those (``collectives.SeqShard``: ceil(T / N) r-strided frames a rank)
    and decodes them (``model.decode``'s ``seq_frames``); the style
    encoder reads the whole ``tar_mel``, gathered; each rank's loss is its
    frames' mean weighted by its share of the frames, and the gradients
    and metrics average over every rank, so that the step's numbers are
    the replicated step's. aux's decoder_attention, reduced_target and
    final_output then hold the rank's frames."""
    loss_fns = _loss_fns(stop_scaling)

    @functools.partial(collectives.sharded_step, mesh=mesh)
    def step(state, batch, mi_loss, rng: int, *, r: int,
             prenet_dropout: float = 0.5, drop_n_heads: int = 0,
             ss_rate: float = 0.0):
        mel, phonemes, stop, spk = batch[:4]
        dev = mel.device
        spk_in = spk[:, None] if model.has_speaker else None
        tar_real, tar_mel, tar_stop, mel_len = model.input_reshape(mel, stop,
                                                                   r)
        seq = collectives.seq_shard()
        frames = None if seq is None else tar_mel.shape[1]

        def local(x, per_frame=1):
            """x's frames on this seq rank (x itself without a seq axis)."""
            return x if seq is None else seq.local(x, frames, 1, per_frame)
        if seq is not None:
            # the rank keeps its frames; the style encoder reads the whole
            # sequence, gathered
            tar_real, tar_stop = local(tar_real, r), local(tar_stop, r)
            tar_mel = seq.gather(local(tar_mel), frames)
        full_len, mel_len = mel_len, tar_real.shape[1]
        dec_inp, style_tar = tar_mel, None if seq is None else tar_mel
        if gta_inputs:
            _, gta_tar, _, _ = model.input_reshape(batch[4], stop, r)
            dec_inp = torch.cat([tar_mel[:, :1], gta_tar[:, 1:]], 1)
            style_tar = tar_mel
        if scheduled_sampling:
            ss_rng = fold_in(rng, 13)
            with torch.no_grad():
                out1 = model(phonemes, local(tar_mel), spk_in, False, False,
                             False, r=r, prenet_dropout=prenet_dropout,
                             style_targets=style_tar,
                             generator=generator(ss_rng, dev),
                             seq_frames=frames)
                pred1 = out1["final_output"]
                if seq is not None:
                    pred1 = seq.gather(pred1, frames, per_frame=r)
            # final_output[:, t] predicts mel[:, t + 1]: prepend the GO
            # frame and shift + r-stride as the targets are
            pred = torch.cat([mel[:, :1], pred1[:, :full_len]],
                             1)[:, :-1][:, 0::r]
            mix = collectives.rand(
                (tar_mel.shape[0], tar_mel.shape[1], 1),
                generator(fold_in(ss_rng, 1), dev), dev) < ss_rate
            dec_inp = torch.where(mix, pred, tar_mel)
            style_tar = tar_mel
        out = model(phonemes, local(dec_inp), spk_in, train_text_encoder,
                    train_style_encoder, train_decoder, r=r,
                    prenet_dropout=prenet_dropout, drop_n_heads=drop_n_heads,
                    style_targets=style_tar, generator=generator(rng, dev),
                    seq_frames=frames)
        tts_loss, vals = _tts_losses(out, tar_real, tar_stop, mel_len,
                                     loss_fns)
        if seq is not None:
            # this rank's share of the whole sequence's means
            share = mel_len * seq.size / full_len
            tts_loss, vals = tts_loss * share, [v * share for v in vals]
        style_loss = tts_loss.new_zeros(())
        if use_style_loss and model.has_style:
            final = out["final_output"]
            if seq is not None:
                final = seq.gather(final, frames, per_frame=r)[:, :full_len]
            with frozen_batch_stats(model):
                gst2 = model.encode_style(
                    final, train_style_encoder, drop_n_heads,
                    generator(fold_in(rng, 7), dev))[0]
            style_loss = l2_loss(gst2, out["gst_output"])
        tts_total = tts_loss + style_loss
        # the zoo reads the global batch, as its estimates are not means
        # over rows (gather_rows: the rows themselves in a single process);
        # in the tape only where the zoo's estimate is
        adversarial = adversarial_mine is not None

        def rows(x):
            return (None if x is None else collectives.gather_rows(
                x if adversarial else x.detach()))
        gst, text = rows(out["gst_output"]), rows(out["text_enc_output"])
        if adversarial:
            spk_m = collectives.gather_rows(
                spk_in if model.has_speaker
                else mel.new_zeros(mel.shape[0], 1, 1))
            mi_live = tts_loss.new_zeros(())
            for i, (kind, net) in enumerate(adversarial_mine):
                draws = pair_draws(text.shape[0], text.shape[1], generator(
                    fold_in(rng, 101 + i), dev))
                res = net(text, gst, spk_m, mi_loss, draws)
                # MINE -> (mi, terms); CLUB -> (lld, bound): the bound
                mi_live = mi_live + (res[1] if kind == "CLUB" else res[0])
        else:
            mi_live = torch.as_tensor(mi_loss, dtype=torch.float32,
                                      device=dev).detach()
        total = tts_total + mi_weight_factor * mi_live.clamp(min=0.0)
        state.apply_gradients(_grads(total, state.params))
        metrics = collectives.global_mean(
            {"loss": total.detach(), "tts_loss": tts_total.detach(),
             "style_loss": style_loss.detach(), "mi_live": mi_live.detach(),
             "losses": {k: v.detach() for k, v in zip(
                 ("output", "stop_prob", "mel_linear"), vals)}})
        detach = lambda x: None if x is None else x.detach()
        aux = {"text_enc_output": detach(text), "gst_output": detach(gst),
               "decoder_attention": {k: v.detach() for k, v in
                                     out["decoder_attention"].items()},
               "reduced_target": local(tar_mel),
               "final_output": out["final_output"].detach()}
        return metrics, aux

    return step


def make_autoregressive_val_step(model, *, stop_scaling: float = 8.0):
    """``step(batch, rng, *, r=1) -> out``: the teacher-forced forward with
    the train flags off and prenet dropout 0.5, as etts fixes it
    (`etts/train/steps.py:281-309`); ``out`` is the model's dict plus
    "tts_loss", "losses" and "reduced_target". The dropout's uniforms are
    drawn on the CPU, so that the step is the same function of ``rng`` on
    every device (duration extraction gives the card's durations)."""
    loss_fns = _loss_fns(stop_scaling)

    @torch.no_grad()
    def step(batch, rng: int, *, r: int = 1):
        mel, phonemes, stop, spk = batch[:4]
        spk_in = spk[:, None] if model.has_speaker else None
        tar_real, tar_mel, tar_stop, mel_len = model.input_reshape(mel, stop,
                                                                   r)
        out = model(phonemes, tar_mel, spk_in, False, False, False, r=r,
                    prenet_dropout=0.5,
                    generator=generator(rng, "cpu"))
        tts_loss, vals = _tts_losses(out, tar_real, tar_stop, mel_len,
                                     loss_fns)
        out.update({"tts_loss": tts_loss,
                    "losses": dict(zip(("output", "stop_prob", "mel_linear"),
                                       vals)),
                    "reduced_target": tar_mel})
        return out

    return step


def make_mine_update(net, kind: str = "MINE"):
    """One MI net's update by gradient ascent (`traning_steps.py:77-82`):
    ``step(state, text_enc_out, gst_out, spk, mi_state, rng) -> (mi,
    exp_terms)``, ``state`` a ``TrainState`` of ``net``. MINE climbs its
    estimate; CLUB climbs its log-likelihood, reports its bound as the MI
    and leaves the exp_terms as they were."""
    def step(state, text_enc_out, gst_out, spk, mi_state: MIState, rng: int):
        draws = pair_draws(text_enc_out.shape[0], text_enc_out.shape[1],
                           generator(rng, text_enc_out.device))
        if kind == "CLUB":
            lld, mi = net(text_enc_out, gst_out, spk, mi_state, draws)
            loss, terms = -lld, mi_state.exp_terms
        else:
            mi, terms = net(text_enc_out, gst_out, spk, mi_state, draws)
            loss = -mi
        state.apply_gradients(_grads(loss, state.params))
        return mi.detach(), terms.detach()

    return step


def make_mine_zoo_update(nets):
    """The whole zoo's updates: ``step(states, text_enc_out, gst_out, spk,
    mi_state, rngs) -> (mis (n,), exp_terms)``, one state and one rng per
    net. Kept from the reference (`etts/train/steps.py:356-358`): the
    driver sums the MIs, and the LAST net's exp_terms are carried."""
    if not nets:
        raise ValueError(
            "make_mine_zoo_update needs a non-empty zoo: check mine_type "
            "(MINE|CLUB|MINE_CLUB) and that system_type derives pair types")
    updates = [make_mine_update(net, kind) for kind, net in nets]

    def step(states, text_enc_out, gst_out, spk, mi_state: MIState, rngs):
        mis, terms = [], mi_state.exp_terms
        for update, state, rng in zip(updates, states, rngs, strict=True):
            mi, terms = update(state, text_enc_out, gst_out, spk, mi_state,
                               rng)
            mis.append(mi)
        return torch.stack(mis), terms

    return step


def make_wavernn_train_step(model, mesh=None):
    """``step(state, batch) -> {"loss"}``, one Adam update of ``state`` (a
    ``TrainState`` of the WaveRNN ``model``) on ``batch`` (x, y, mels) as
    ``data.dataset.collate_vocoder`` makes it, on the model's device
    (`etts/train/steps.py:385-414`): the teacher-forced forward in train
    mode, whose BatchNorm moves its running statistics, then the
    discretized-MoL loss (MOL, y floats) or the cross-entropy (RAW, y
    int64 labels). No randomness: the step takes no seed. ``mesh``: a
    ("data", "model") mesh of a tensor-parallel ``model``."""
    @functools.partial(collectives.sharded_step, mesh=mesh)
    def step(state, batch):
        x, y, mels = batch
        logits = model(x, mels, train=True)
        loss = (discretized_mix_logistic_loss(logits, y[..., None])
                if model.mode == "MOL" else raw_loss(logits, y))
        state.apply_gradients(_grads(loss, state.params))
        return collectives.global_mean({"loss": loss.detach()})

    return step


def make_tacotron_train_step(model):
    """``step(state, batch, rng) -> metrics``, one update
    of ``state`` (a ``TrainState`` of the GST-Tacotron ``model``, which
    clips and applies Adam) on ``batch`` (ids (b, n), lengths (b,), mel
    targets (b, t, num_mels), linear targets (b, t, num_freq); t a
    multiple of r) on the model's device (`etts/train/steps.py:421-449`):
    the teacher-forced forward in train mode (the BatchNorms' running
    statistics move), ``tacotron_loss``. The prenets' and zoneout's
    uniforms are ``model.draw_uniforms(..., seed=rng, zoneout=True)``'s,
    drawn on the CPU: one rng gives every device the same. Metrics: {"loss", "mel_loss", "linear_loss",
    "ref_enc_loss", "alignments" (b, t // r, n)}, on the device."""
    @collectives.sharded_step
    def step(state, batch, rng: int):
        inputs, input_lengths, mel_targets, linear_targets = batch
        uniforms = model.draw_uniforms(
            inputs.shape[0], inputs.shape[1], mel_targets.shape[1] // model.r,
            seed=rng, device=inputs.device, zoneout=True)
        out = model(inputs, input_lengths, mel_targets,
                    {k: u.to(mel_targets.dtype) for k, u in uniforms.items()},
                    train=True)
        loss, parts = tacotron_loss(out, mel_targets, linear_targets)
        state.apply_gradients(_grads(loss, state.params))
        return collectives.global_mean(
            {"loss": loss.detach(),
             **{k: v.detach() for k, v in parts.items()},
             "alignments": out["alignments"].detach()})

    return step
