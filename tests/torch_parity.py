"""Shared helpers for the JAX-vs-port parity tests (``test_torch_*.py``):
build the same tiny model in flax and in ``etts_torch`` from one set of
params, carried over through the exported flat-npz layout."""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from etts_torch.convert import load_into, seeded_flat

# the models here are tiny; two threads per test process keep parallel
# test workers from crowding the CPU that the timing tests measure on
torch.set_num_threads(min(2, torch.get_num_threads()))


def flatten(variables) -> dict:
    """flax variables -> the flat ``keystr`` dict export_params_npz writes."""
    flat = {}

    def collect(prefix):
        def f(path, leaf):
            flat[prefix + jax.tree_util.keystr(path)] = np.asarray(
                leaf, np.float32)
        return f
    jax.tree_util.tree_map_with_path(collect(""), variables["params"])
    if variables.get("batch_stats"):
        jax.tree_util.tree_map_with_path(collect("batch_stats:"),
                                         variables["batch_stats"])
    return flat


def unfreeze(variables):
    """A copy with fresh (mutable) dict containers, arrays shared."""
    if isinstance(variables, dict) or hasattr(variables, "items"):
        return {k: unfreeze(v) for k, v in variables.items()}
    return variables


def randomize_batch_stats(variables, seed=0):
    """Non-trivial BatchNorm running stats so inference BN is exercised."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if name.endswith("['var']"):
            return jax.numpy.asarray(rng.uniform(0.5, 1.5, shape), np.float32)
        return jax.numpy.asarray(rng.normal(0, 0.1, shape), np.float32)
    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        f, variables["batch_stats"])
    return out


AR_TINY = dict(encoder_model_dimension=32, decoder_model_dimension=32,
               encoder_num_heads=(2, 2), decoder_num_heads=(2, 2),
               encoder_dense_blocks=2, decoder_dense_blocks=2,
               encoder_feed_forward_dimension=48,
               decoder_feed_forward_dimension=48,
               encoder_prenet_dimension=32, decoder_prenet_dimension=24,
               postnet_conv_filters=16, postnet_conv_layers=3,
               postnet_kernel_size=3, encoder_maximum_position_encoding=100,
               decoder_maximum_position_encoding=300, mel_channels=12,
               vocab_size=40, ref_encoder_filters=(4, 8),
               ref_encoder_gru_cell_units=8, gst_style_embed_dim=16,
               gst_multi_num_heads=2, gst_heads=5, max_r=3)
SPK_DIM = 256


@functools.lru_cache(maxsize=16)
def _ar_init(system_type, seed, batch_stats, over):
    from etts.models.autoregressive import AutoregressiveTransformer as JM
    cfg = dict(AR_TINY, **dict(over))
    jm = JM(system_type=system_type, **cfg)
    key = jax.random.PRNGKey(seed)
    phon = jax.random.randint(key, (1, 7), 1, cfg["vocab_size"])
    mel = jax.random.normal(key, (1, 9, cfg["mel_channels"])) * 0.3
    spk = (jax.numpy.zeros((1, 1, SPK_DIM))
           if "speaker" in system_type else None)
    variables = jm.init({"params": key, "dropout": key, "prenet": key},
                        phon, mel, spk, r=1)
    variables = dict(variables)
    if batch_stats:
        variables = randomize_batch_stats(variables, seed)
    return jm, variables


def ar_pair(system_type="text", seed=0, batch_stats=True, **over):
    """(flax model, variables, torch model) sharing one random init; the
    variables are fresh containers, safe to edit."""
    from etts_torch.models.autoregressive import (
        AutoregressiveTransformer as TM)
    cfg = dict(AR_TINY, **over)
    jm, variables = _ar_init(system_type, seed, batch_stats,
                             tuple(sorted(over.items())))
    variables = unfreeze(variables)
    tcfg = {k: v for k, v in cfg.items()
            if k not in ("encoder_maximum_position_encoding",
                         "decoder_maximum_position_encoding")}
    tm = TM(system_type=system_type, speaker_embed_dim=SPK_DIM,
            encoder_maximum_position_encoding=cfg[
                "encoder_maximum_position_encoding"],
            decoder_maximum_position_encoding=cfg[
                "decoder_maximum_position_encoding"], **tcfg)
    load_into(tm, flatten(variables))
    return jm, variables, tm


def unflatten(flat: dict) -> dict:
    """The flat ``keystr`` dict -> flax variables {'params', and
    'batch_stats' where it has any}: the inverse of ``flatten``."""
    out = {}
    for key, a in flat.items():
        col = "batch_stats" if key.startswith("batch_stats:") else "params"
        node = out.setdefault(col, {})
        *path, leaf = re.findall(r"\['([^']+)'\]",
                                 key.removeprefix("batch_stats:"))
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(a)
    return out


def seeded_variables(module, seed=0) -> dict:
    """Seed a port module in place (``seeded_flat``, 1-D parameters normal
    0.1) and return its weights as flax variables, with no flax init."""
    return unflatten(seeded_flat(module, seed, std_1d=0.1))


def t(x, dtype=None):
    """numpy / jax array -> torch tensor (CPU)."""
    return torch.from_numpy(np.array(x, dtype=dtype))


VOC_TINY = dict(rnn_dims=16, fc_dims=16, bits=4, pad=2,
                upsample_factors=(2, 5), feat_dims=8, compute_dims=8,
                res_out_dims=8, res_blocks=2, hop_length=10)


def voc_pair(mode="MOL", peaky=None, batch_stats=True):
    """(flax WaveRNN, variables, torch WaveRNN) of VOC_TINY sharing one
    random init; ``peaky`` scales fc3's kernel (a near-delta categorical in
    RAW mode makes sampling an argmax)."""
    from etts.models.wavernn import WaveRNN as JW
    from etts_torch.models.wavernn import WaveRNN as TW
    jm = JW(mode=mode, sample_rate=100, **VOC_TINY)
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((2, 50)),
                jax.random.normal(jax.random.PRNGKey(0), (2, 9, 8)), False)
    v = {k: dict(x) for k, x in v.items()}
    # the smoothing kernels init to a constant 1/k, which would hide a
    # reversed kernel: give them distinct values
    up = dict(v["params"]["upsample"])
    rng = np.random.default_rng(7)
    for name in ("smooth_0", "smooth_1"):
        k = up[name]["kernel"]
        up[name] = {"kernel": jnp.asarray(rng.uniform(0, 0.3, k.shape),
                                          jnp.float32)}
    v["params"]["upsample"] = up
    if batch_stats:
        v = randomize_batch_stats(v)
    if peaky:
        v["params"] = dict(v["params"])
        v["params"]["fc3"] = dict(v["params"]["fc3"])
        v["params"]["fc3"]["kernel"] = v["params"]["fc3"]["kernel"] * peaky
    return jm, v, load_into(TW(mode=mode, **VOC_TINY), flatten(v))


ROOT = Path(__file__).resolve().parents[1]
TTS_SMALL = dict(
    decoder_model_dimension=32, encoder_model_dimension=32,
    decoder_num_heads=[2, 2], encoder_num_heads=[2, 2],
    encoder_feed_forward_dimension=48, decoder_feed_forward_dimension=48,
    decoder_prenet_dimension=24, encoder_prenet_dimension=32,
    encoder_attention_conv_filters=32, decoder_attention_conv_filters=32,
    postnet_conv_filters=16, postnet_conv_layers=3, postnet_kernel_size=3,
    encoder_dense_blocks=2, decoder_dense_blocks=2,
    ref_encoder_filters=[4, 8], ref_encoder_gru_cell_units=8,
    gst_style_embed_dim=16, gst_multi_num_heads=2, gst_heads=5,
    reduction_factor_schedule=[[0, 2], [80000, 1]])
# the forward model: one dense and one conv block in the encoder and in
# the decoder, a capacity of 96 frames
FWD_SMALL = dict(
    decoder_model_dimension=32, encoder_model_dimension=32,
    decoder_num_heads=[2, 2], encoder_num_heads=[2, 2],
    encoder_feed_forward_dimension=48, decoder_feed_forward_dimension=48,
    encoder_attention_conv_filters=24, decoder_attention_conv_filters=20,
    postnet_conv_filters=16, postnet_conv_layers=3, postnet_kernel_size=3,
    encoder_dense_blocks=1, decoder_dense_blocks=1, max_frames=96)
VOC_SMALL = dict(voc_mode="RAW", voc_rnn_dims=16, voc_fc_dims=16,
                 voc_compute_dims=8, voc_res_out_dims=8, voc_res_blocks=2,
                 voc_target=600, voc_overlap=50)


def _jit_init(model, kind):
    """The inputs of etts.utils.config._init_variables, under jit (a few
    times faster than its eager init)."""
    k = jax.random.PRNGKey(0)
    if kind == "autoregressive":
        rngs = {"params": k, "dropout": k, "prenet": k}
        return jax.jit(lambda g, ids, mel, spk: model.init(g, ids, mel, spk,
                                                           r=1))(
            rngs, jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 6, 80)),
            jnp.zeros((1, 1, 256)))
    return jax.jit(lambda g, x, mel: model.init(g, x, mel, False))(
        k, jnp.zeros((1, 4 * 200)), jnp.zeros((1, 8, 80)))


def _seeded_forward(d: Path) -> dict:
    """The forward model of config dir ``d`` on seeded port weights
    (drawn as ``seeded_variables`` draws them, seed 0; no flax init to
    compile), the duration head's bias 1 frame, as flax variables."""
    from etts_torch.utils.config import (build_forward, load_config,
                                         text_pipeline)
    cfg = load_config(d, "forward")
    vocab = text_pipeline(cfg, "grapheme", "forward").tokenizer.vocab_size
    flat = seeded_flat(build_forward(cfg, vocab), 0, std_1d=0.1)
    flat["['dur_pred']['linear']['bias']"][:] = 1.0
    return unflatten(flat)


def small_workspace(d: Path, kinds=("autoregressive", "wavernn")) -> dict:
    """Config dir ``d`` of configs/default shrunk by TTS_SMALL, FWD_SMALL
    and VOC_SMALL, the flat npz exports of one init of each model of
    ``kinds`` (the forward model's from ``_seeded_forward``; the vocoder
    a near-delta RAW categorical, so its sampling is an argmax), a seeded
    reference wav and speaker vector. Returns {'dir', one (ConfigManager,
    flax model, variables) under each kind, 'wav', 'spk'}."""
    from etts.utils.config import ConfigManager
    small = {"autoregressive": TTS_SMALL, "forward": FWD_SMALL,
             "wavernn": VOC_SMALL}
    for kind, over in [(k, small[k]) for k in kinds] + [
            ("data", {"phonemizer_backend": "grapheme",
                      "log_directory": str(d / "logs")})]:
        cfg = yaml.safe_load(open(ROOT / "configs/default" /
                                  f"{kind}_config.yaml"))
        cfg.update(over)
        yaml.safe_dump(cfg, open(d / f"{kind}_config.yaml", "w"))
    out = {"dir": d}
    for kind in kinds:
        cm = ConfigManager(str(d), kind)
        model = cm.get_model(ignore_hash=True)
        if kind == "forward":
            variables = _seeded_forward(d)
        else:
            variables = dict(_jit_init(model, kind))
        if kind == "wavernn":   # near-delta categorical: argmax sampling
            p = {k: dict(v) if hasattr(v, "items") else v
                 for k, v in variables["params"].items()}
            p["fc3"]["kernel"] = p["fc3"]["kernel"] * 1e6
            variables["params"] = p
        np.savez(d / f"{kind}.npz", **flatten(variables))
        out[kind] = (cm, model, variables)
    wav = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    out["wav"] = 0.2 * wav
    out["spk"] = np.random.default_rng(1).standard_normal(256).astype(
        np.float32)
    return out


# ---------------------------------------------------------------------------
# training parity (test_torch_train_*.py)
# ---------------------------------------------------------------------------

def train_pair(system_type="speaker_style_text", seed=0, **over):
    """(flax model, variables, torch model) of AR_TINY and ``over``: the
    port model initialised by ``init_flax`` (seeded, no flax init to
    compile), its BatchNorm statistics seeded (means normal 0.1, variances
    in [0.5, 1.5]), handed to flax through the flat layout."""
    from etts.models.autoregressive import AutoregressiveTransformer as JM
    from etts_torch.convert import export_flat
    from etts_torch.models.autoregressive import (
        AutoregressiveTransformer as TM)
    cfg = dict(AR_TINY, **over)
    tm = TM(system_type=system_type, speaker_embed_dim=SPK_DIM, **cfg)
    _seeded_init(tm, seed)
    return (JM(system_type=system_type, **cfg), unflatten(export_flat(tm)),
            tm.eval())


def _seeded_init(tm, seed):
    """``init_flax`` from ``seed``, then the BatchNorm statistics seeded
    (means normal 0.1, variances in [0.5, 1.5])."""
    from etts_torch.models.init import init_flax
    g = torch.Generator().manual_seed(seed)
    init_flax(tm, g)
    with torch.no_grad():
        for name, b in tm.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)


# the forward model: a 1 dense + 1 conv encoder, a 2 dense + 1 conv decoder
FWD_TINY = dict(encoder_model_dimension=32, decoder_model_dimension=32,
                encoder_num_heads=(2, 2), decoder_num_heads=(2, 2, 2),
                encoder_dense_blocks=1, decoder_dense_blocks=2,
                encoder_feed_forward_dimension=48,
                decoder_feed_forward_dimension=40, postnet_conv_filters=16,
                postnet_conv_layers=3, postnet_kernel_size=3, mel_channels=12,
                vocab_size=40, encoder_attention_conv_filters=24,
                decoder_attention_conv_filters=20,
                encoder_maximum_position_encoding=100,
                decoder_maximum_position_encoding=200)


def forward_train_pair(seed=0, dropout_rate=0.0):
    """(flax ForwardTransformer, variables, torch model) of FWD_TINY at
    ``dropout_rate``, as ``train_pair``: the port model initialised by
    ``init_flax`` and its BatchNorm statistics seeded, handed to flax
    through the flat layout."""
    from etts.models.forward import ForwardTransformer as JF
    from etts_torch.convert import export_flat
    from etts_torch.models.forward import ForwardTransformer as TF
    tm = TF(**FWD_TINY, dropout_rate=dropout_rate)
    _seeded_init(tm, seed)
    return (JF(**FWD_TINY, dropout_rate=dropout_rate),
            unflatten(export_flat(tm)), tm.eval())


def forward_train_batch(seed=0, b=3, n=9, max_frames=48, mel_c=12):
    """A batch as etts' ForwardDataPrepper and Dataset make it: ids and
    integer durations (0-5 frames, some 0) zero-padded to ``n``, each
    mel as long as its durations' sum, zero-padded to ``max_frames``.
    Returns numpy (mel, phonemes, durations)."""
    rng = np.random.default_rng(seed)
    mel = np.zeros((b, max_frames, mel_c), np.float32)
    phon = np.zeros((b, n), np.int32)
    dur = np.zeros((b, n), np.float32)
    for i in range(b):
        k = n if i == 0 else int(rng.integers(n // 2, n))
        phon[i, :k] = rng.integers(1, FWD_TINY["vocab_size"], k)
        dur[i, :k] = rng.integers(0, 6, k)
        t = int(dur[i].sum())
        mel[i, :t] = rng.normal(0, 1, (t, mel_c))
    return mel, phon, dur


def capture_tx():
    """An optax transformation that applies no update and keeps the
    gradients it is given as its state: etts' gradients, exactly, as
    ``new_state.opt_state``."""
    import optax
    zeros = lambda tree: jax.tree.map(jnp.zeros_like, tree)
    return optax.GradientTransformation(
        zeros, lambda g, state, params=None: (zeros(g), g))


def capture_state(module, frozen=()):
    """A port ``TrainState`` of ``module`` whose ``apply_gradients`` keeps
    the gradients ({parameter name: grad}) as ``.grads`` and updates
    nothing."""
    from etts_torch.train.state import TrainState

    class Capture(TrainState):
        def apply_gradients(self, grads):
            self.grads = dict(zip(self.names, grads))
            self.step += 1
    return Capture(module, [[0, 1e-3]], frozen=frozen)


def torch_grads(flax_grads) -> dict:
    """etts' gradient tree -> {port parameter name: numpy grad}, in the
    port's layout."""
    from etts_torch.convert import _to_torch_layout, _torch_name
    return {_torch_name(k): _to_torch_layout(k, g)
            for k, g in flatten({"params": flax_grads}).items()}


def assert_grads_close(want: dict, got: dict, rtol: float, atol: float):
    """Per tensor: ||got - want|| <= rtol * ||want|| + atol. ``atol`` is
    for the gradients that are zero in exact arithmetic (a key bias under
    the softmax, a conv bias before a BatchNorm on batch statistics), which
    float32 leaves at rounding noise."""
    assert set(want) == set(got), set(want) ^ set(got)
    for name, w in want.items():
        g = np.asarray(got[name])
        err = np.linalg.norm(g - w)
        assert err <= rtol * np.linalg.norm(w) + atol, (
            name, err, np.linalg.norm(w))


def ar_train_batch(seed=0, b=4, t_mel=22, n=9, mel_c=12, spk_d=SPK_DIM):
    """A batch as etts' DataPrepper and Dataset make it: rows of other
    lengths, each mel between the start (0.5) and end (-0.5) vectors,
    stop class 1 and 2 at the last frame, zero padding (stop 0) after;
    ids zero-padded. Returns numpy (mel, phonemes, stop, spk)."""
    rng = np.random.default_rng(seed)
    mel = np.zeros((b, t_mel, mel_c), np.float32)
    stop = np.zeros((b, t_mel), np.int32)
    phon = np.zeros((b, n), np.int32)
    for i in range(b):
        length = t_mel - 2 if i == 0 else int(rng.integers(t_mel // 2,
                                                           t_mel - 2))
        mel[i, 0], mel[i, length + 1] = 0.5, -0.5
        mel[i, 1:length + 1] = rng.normal(0, 0.5, (length, mel_c))
        stop[i, :length + 2] = 1
        stop[i, length + 1] = 2
        k = n if i == 0 else int(rng.integers(n // 2, n))
        phon[i, :k] = rng.integers(1, AR_TINY["vocab_size"], k)
    spk = rng.normal(size=(b, spk_d)).astype(np.float32)
    return mel, phon, stop, spk


def to_jax(batch):
    return tuple(jnp.asarray(x) for x in batch)


def to_torch(batch):
    """numpy batch -> torch, ids and stop classes as int64."""
    return tuple(torch.from_numpy(x).long() if x.dtype == np.int32
                 else torch.from_numpy(x) for x in batch)


TRAIN_TINY = dict(TTS_SMALL, reduction_factor_schedule=[[0, 3]],
                  tts_batch_size=4, use_mine=True,
                  mine_batch_size_schedule=[[0, 4]],
                  mine_dense_hidden_units=[16, 8], weights_save_frequency=2,
                  prediction_frequency=2, prediction_start_step=0,
                  metrics_sync_frequency=1, keep_n_weights=2)


def tiny_corpus(d: Path, n=12, mel_c=12, spk_d=SPK_DIM, seed=0, **over):
    """A corpus in create_dataset.py's layout under ``d/corpus``
    (train_metafile.txt ``id|text|phonemes``, mels/*.npy (t, mel_c),
    spk_embeds/*.npy), 10-40 frames and 5-13 phonemes an utterance, and a
    config dir ``d`` of configs/default shrunk by TRAIN_TINY and ``over``
    (mel_c channels, logs under ``d/logs``). Returns the sample ids."""
    from etts_torch.text.symbols import _phonemes
    rng = np.random.default_rng(seed)
    corpus = d / "corpus"
    (corpus / "mels").mkdir(parents=True, exist_ok=True)
    (corpus / "spk_embeds").mkdir(exist_ok=True)
    alpha = sorted(_phonemes)
    lines = []
    for i in range(n):
        np.save(corpus / "mels" / f"u{i}.npy", rng.uniform(
            -4, 4, (int(rng.integers(10, 40)), mel_c)).astype(np.float32))
        np.save(corpus / "spk_embeds" / f"u{i}.npy",
                rng.normal(size=spk_d).astype(np.float32))
        phon = "".join(rng.choice(alpha, int(rng.integers(5, 14))))
        lines.append(f"u{i}|Text number {i}.|{phon}\n")
    (corpus / "train_metafile.txt").write_text("".join(lines))
    for kind, cfg_over in (("autoregressive", dict(TRAIN_TINY, **over)),
                           ("data", dict(
                               mel_channels=mel_c, phonemizer_backend=None,
                               train_data_directory=str(corpus),
                               log_directory=str(d / "logs")))):
        cfg = yaml.safe_load(open(ROOT / "configs/default" /
                                  f"{kind}_config.yaml"))
        cfg.update(cfg_over)
        yaml.safe_dump(cfg, open(d / f"{kind}_config.yaml", "w"))
    return [f"u{i}" for i in range(n)]


def r1_session(d: Path, **over):
    """A tiny corpus with a test split (its last 3 utterances) and an AR
    model trained by the port for 2 steps at r = 1 (session "s")."""
    from etts_torch.train_autoregressive import main as train_ar
    tiny_corpus(d, reduction_factor_schedule=[[0, 1]], use_mine=False,
                **over)
    corpus = d / "corpus"
    lines = (corpus / "train_metafile.txt").read_text().splitlines(True)
    (corpus / "test_metafile.txt").write_text("".join(lines[-3:]))
    train_ar(["--config", str(d), "--device", "cpu", "--session_name", "s",
              "--max_steps", "2"])
    return corpus


_ETTS_STEPS = {}


def etts_step(jm, tx=None, **opts):
    """etts' make_autoregressive_train_step(jm, tx, stop_scaling=8, **opts),
    kept per process and options so that its jit compiles once (tx None:
    ``capture_tx``)."""
    from etts.train import make_autoregressive_train_step
    key = (id(jm), id(tx), tuple(sorted(
        (k, id(v) if isinstance(v, list) else v) for k, v in opts.items())))
    if key not in _ETTS_STEPS:
        _ETTS_STEPS[key] = (jm, make_autoregressive_train_step(
            jm, tx or capture_tx(), stop_scaling=8.0, **opts))
    return _ETTS_STEPS[key][1]


def step_pair(pair, batch, *, r, mi=0.0, ss_rate=0.0, jax_mi=None,
              key=0, **opts):
    """One train step of etts (gradients kept by ``capture_tx``) and of the
    port (``capture_state``) from the same weights, dropout 0, prenet
    dropout 0, no head drop. Returns ((etts state, metrics), (port state,
    metrics, the port model's weights after the step (``export_flat``)));
    the port model is reloaded from the weights first."""
    from etts.train import TrainState as JState
    from etts_torch.train.steps import make_autoregressive_train_step
    jm, v, tm = pair
    step = etts_step(jm, **{k: v_ for k, v_ in opts.items()
                            if k != "adversarial_mine"},
                     **({"adversarial_mine": opts["adversarial_mine"][0]}
                        if "adversarial_mine" in opts else {}))
    jst, jmet, _ = step(JState.create(v, capture_tx()), to_jax(batch),
                        jnp.asarray(mi) if jax_mi is None else jax_mi,
                        jax.random.PRNGKey(key), r=r, prenet_dropout=0.0,
                        ss_rate=ss_rate)
    load_into(tm, flatten(v))
    topts = dict(opts)
    if "adversarial_mine" in topts:
        topts["adversarial_mine"] = topts["adversarial_mine"][1]
    cs = capture_state(tm)
    tmet, _ = make_autoregressive_train_step(tm, stop_scaling=8.0, **topts)(
        cs, to_torch(batch), mi, key, r=r, prenet_dropout=0.0,
        ss_rate=ss_rate)
    from etts_torch.convert import export_flat
    return (jst, jmet), (cs, tmet, export_flat(tm))


def assert_step_close(j, p, rtol=1e-4, atol=1e-7, metric_atol=1e-7):
    """The port's step against etts': every gradient (``assert_grads_close``
    at ``rtol`` / ``atol``), the BatchNorm statistics after it within 1e-6,
    and every metric (those under "losses" too) within 1e-5 relative
    (``metric_atol`` absolute)."""
    (jst, jmet), (cs, tmet, got) = j, p
    assert_grads_close(torch_grads(jst.opt_state), cs.grads, rtol, atol)
    want = flatten({"params": jst.params, "batch_stats": jst.batch_stats})
    for k in (k for k in want if k.startswith("batch_stats")):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    flat = lambda m: {**{k: v for k, v in m.items() if k != "losses"},
                      **m.get("losses", {})}
    for k, w in flat(jmet).items():
        np.testing.assert_allclose(float(flat(tmet)[k]), float(w),
                                   rtol=1e-5, atol=metric_atol, err_msg=k)


# ---------------------------------------------------------------------------
# GST-Tacotron parity (test_torch_tacotron*.py)
# ---------------------------------------------------------------------------

# tests/test_tacotron.py's TINY: every width cut, K = 16 and 8 kept
TACO_TINY = dict(vocab_size=30, embed_depth=16, attention_depth=16,
                 rnn_depth=16, num_mels=10, num_freq=33, outputs_per_step=2,
                 prenet_depths=(16, 8), num_gst=4, num_heads=2,
                 style_embed_depth=16, style_att_dim=8,
                 reference_filters=(4, 8), reference_depth=8, max_iters=6,
                 cbhg_width=8)


def flax_shapes(jmodule, *args, **kwargs) -> dict:
    """{keystr: shape} of every variable of ``jmodule.init(rngs, *args,
    **kwargs)``, batch statistics under the ``batch_stats:`` prefix, from
    ``jax.eval_shape``: no initialiser runs (flax's take some 20 s to
    compile for a tiny Tacotron)."""
    k = jax.random.PRNGKey(0)
    rngs = {n: k for n in ("params", "prenet", "zoneout", "dropout",
                           "style")}
    tree = jax.eval_shape(lambda: jmodule.init(rngs, *args, **kwargs))
    out = {}
    for col, prefix in (("params", ""), ("batch_stats", "batch_stats:")):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree.get(col, {})):
            out[prefix + jax.tree_util.keystr(path)] = leaf.shape
    return out


def draw_flat(shapes: dict, seed=0) -> dict:
    """Weights of those shapes in the flat export layout, drawn with numpy:
    kernels and matrices normal 1 / sqrt(fan in) in flax's (..., in, out)
    layout, BatchNorm means normal 0.1 and variances uniform in [0.5,
    1.5], scales 1 + normal 0.1, other parameters normal 0.1."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in shapes.items():
        if key.endswith("['var']"):
            a = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("['scale']"):
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif len(shape) >= 2:
            a = rng.normal(0.0, float(np.prod(shape[:-1])) ** -0.5, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        flat[key] = a.astype(np.float32)
    return flat


@functools.lru_cache(maxsize=8)
def _taco_tree(over):
    from etts.models.tacotron import Tacotron as JT
    jm = JT(**dict(TACO_TINY, **dict(over)))
    return jm, flax_shapes(jm, jnp.ones((2, 7), jnp.int32),
                           jnp.array([7, 5]),
                           jnp.zeros((2, 12, TACO_TINY["num_mels"])))


def taco_flat(seed=0, **over) -> dict:
    """``draw_flat`` weights for every variable of the flax Tacotron of
    TACO_TINY and ``over``."""
    return draw_flat(_taco_tree(tuple(sorted(over.items())))[1], seed)


def taco_pair(seed=0, flat=None, **over):
    """(flax Tacotron, its variables, the port's Tacotron) of TACO_TINY and
    ``over`` on one set of weights (``taco_flat``'s, or ``flat``), carried
    into the port by ``convert``."""
    from etts_torch.models.tacotron import Tacotron as TT
    jm, _ = _taco_tree(tuple(sorted(over.items())))
    flat = taco_flat(seed, **over) if flat is None else flat
    tm = load_into(TT(**dict(TACO_TINY, **over)), flat)
    return jm, unflatten(flat), tm


# TACO_TINY as tacotron_config.yaml keys (etts' ref_proj_dim stays 128),
# batches of 2, a checkpoint every 2 steps, the losses every step
TACO_TRAIN = dict(
    embed_depth=16, attention_depth=16, rnn_depth=16, num_freq=33,
    outputs_per_step=2, prenet_depths=[16, 8], num_gst=4, num_heads=2,
    style_embed_depth=16, style_att_dim=8, reference_filters=[4, 8],
    reference_depth=8, cbhg_width=8, max_iters=6, batch_size=2,
    checkpoint_interval=2, metrics_sync_frequency=1, griffin_lim_iters=2)
TACO_AUDIO = dict(sampling_rate=16000, n_fft=64, hop_length=10,
                  win_length=40, mel_channels=10, f_min=0, f_max=None)
TACO_TEXTS = ("Hello there.", "The quick brown fox, 2 times.",
              "Good morning!", "Dr. Smith is here.", "What time is it?",
              "Thank you very much.")


def taco_workspace(d: Path) -> Path:
    """A config dir (configs/default's tacotron_config.yaml shrunk by
    TACO_TRAIN, logs under ``logs``) and its store: 6 seeded wavs of
    150-300 samples (15-30 frames) in the LJSpeech layout through
    ``build_tacotron_dataset`` into ``taco_training``."""
    from etts_torch.data.audio_io import save_wav
    from etts_torch.data.taco_builders import build_tacotron_dataset
    rng = np.random.default_rng(0)
    (d / "wavs").mkdir()
    lines = []
    for i, text in enumerate(TACO_TEXTS):
        save_wav(voc_wav(rng, int(rng.integers(150, 301))),
                 d / "wavs" / f"t{i}.wav", 16000)
        lines.append(f"t{i}|{text}|{text}\n")
    (d / "metadata.csv").write_text("".join(lines))
    data = dict(TACO_AUDIO, data_directory=str(d),
                train_data_directory=str(d / "taco_training"),
                log_directory=str(d / "logs"))
    taco = yaml.safe_load(open(ROOT / "configs/default" /
                               "tacotron_config.yaml"))
    taco.update(TACO_TRAIN)
    for name, cfg in (("data", data), ("tacotron", taco)):
        (d / f"{name}_config.yaml").write_text(yaml.safe_dump(cfg))
    build_tacotron_dataset({**taco, **data},
                           out_dir=data["train_data_directory"], njobs=1,
                           device="cpu")
    return d


# ---------------------------------------------------------------------------
# vocoder training parity (test_torch_wavernn_*.py, test_torch_vocoder_data)
# ---------------------------------------------------------------------------

# the audio of the tiny vocoder store: a 10-sample hop, 8 mel channels
VOC_AUDIO = dict(sampling_rate=16000, n_fft=64, hop_length=10,
                 win_length=40, mel_channels=8, f_min=0, f_max=None,
                 normalizer="WaveRNN")
# VOC_TINY's widths as wavernn_config.yaml keys, and the driver's cuts:
# batches of 4 crops of 5 hops, a checkpoint and one test utterance
# vocoded every 2 steps, 2 held out
VOC_TRAIN = dict(voc_rnn_dims=16, voc_fc_dims=16, voc_compute_dims=8,
                 voc_res_out_dims=8, voc_res_blocks=2,
                 voc_upsample_factors=[2, 5], voc_batch_size=4,
                 voc_checkpoint_every=2, voc_gen_at_checkpoint=1,
                 voc_test_samples=2, voc_target=60, voc_overlap=10,
                 metrics_sync_frequency=1,
                 learning_rate_tts_schedule=[[0, 1e-3]])


def voc_wav(rng, n):
    """n samples of a gliding harmonic tone plus noise, peak 0.5."""
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(150, 400) + 200 * t
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    wav = sum(np.sin(k * phase) / k for k in range(1, 6))
    wav = wav + 0.05 * rng.standard_normal(n)
    return (0.5 * wav / np.abs(wav).max()).astype(np.float32)


def voc_store(d: Path, mode="MOL", n=10, seed=0, **over):
    """A config dir ``d`` (configs/default's wavernn_config.yaml shrunk by
    VOC_TRAIN, ``voc_mode`` and ``over``; data_config.yaml with VOC_AUDIO,
    logs under ``d/logs``), ``n`` seeded wavs of 200-600 samples (and one
    of 100, too short for a window) under ``d/wavs``, and the port's
    vocoder store of them under ``d/store``. Returns the store's path."""
    from etts_torch.data.audio_io import save_wav
    from etts_torch.data.builders import build_vocoder_dataset
    rng = np.random.default_rng(seed)
    (d / "wavs").mkdir(parents=True, exist_ok=True)
    for i in range(n + 1):
        length = 100 if i == n else int(rng.integers(200, 601))
        save_wav(voc_wav(rng, length), d / "wavs" / f"w{i:02d}.wav", 16000)
    for kind, cfg_over in (("wavernn", dict(VOC_TRAIN, voc_mode=mode,
                                            **over)),
                           ("data", dict(VOC_AUDIO,
                                         log_directory=str(d / "logs")))):
        cfg = yaml.safe_load(open(ROOT / "configs/default" /
                                  f"{kind}_config.yaml"))
        cfg.update(cfg_over)
        yaml.safe_dump(cfg, open(d / f"{kind}_config.yaml", "w"))
    cfg = {**yaml.safe_load(open(d / "data_config.yaml")),
           **yaml.safe_load(open(d / "wavernn_config.yaml"))}
    return Path(build_vocoder_dataset(
        d / "wavs", d / "store", cfg, mode=mode, bits=cfg["bits"],
        mu_law=cfg["mu_law"], njobs=2, device="cpu"))


def voc_train_pair(mode="MOL", seed=0):
    """(flax WaveRNN, variables, torch WaveRNN) of VOC_TINY: the port
    model initialised by ``init_flax`` from ``seed``, its BatchNorm
    statistics seeded (``_seeded_init``), handed to flax through the flat
    layout; the smoothing kernels given distinct values, as ``voc_pair``
    does."""
    from etts.models.wavernn import WaveRNN as JW
    from etts_torch.convert import export_flat
    from etts_torch.models.wavernn import WaveRNN as TW
    tm = TW(mode=mode, **VOC_TINY)
    _seeded_init(tm, seed)
    with torch.no_grad():
        for i in range(2):
            w = getattr(tm.upsample, f"smooth_{i}").weight
            w.uniform_(0.0, 0.3, generator=torch.Generator().manual_seed(i))
    return (JW(mode=mode, sample_rate=100, **VOC_TINY),
            unflatten(export_flat(tm)), tm)
