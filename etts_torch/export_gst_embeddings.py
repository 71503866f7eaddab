"""Export per-utterance GST style embeddings (port of
``scripts/export_gst_embeddings.py``).

    python -m etts_torch.export_gst_embeddings --config DIR \\
        --weights model.npz [--model_kind autoregressive|tacotron] \\
        [--metafile train_metafile.txt] [--mel_dir mels] \\
        [--out_dir gst_embeddings] [--device cuda|cpu]

Every utterance's mel of the TTS store (``train_metafile.txt`` and
``mels/`` under the config's ``train_data_directory``, else its
``data_directory``) goes through the trained style encoder: the AR model's
``encode_style`` (the first row of its output), or GST-Tacotron's
reference encoder and style attention over its tanh'd tokens. One
embedding ``.npy`` per utterance, named as its mel, the input of
``plot_scripts/plot_speaker_embeddings.py``. A flat npz export replaces
etts' session.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def load_model(config_dir, model_kind: str, weights, device):
    """The ``model_kind`` model of ``config_dir`` with the export's weights,
    on ``device``."""
    from .convert import load_into
    from .text import default_tokenizer
    from .utils.config import build_tacotron, build_tts, load_config
    config = load_config(config_dir, model_kind)
    model = (build_tts(config, default_tokenizer(True).vocab_size)
             if model_kind == "autoregressive" else build_tacotron(config))
    return load_into(model, weights).to(device)


def style_embedder(model):
    """mel (b, t, n_mels) tensor -> style embedding (b, width) of an
    ``AutoregressiveTransformer`` (``encode_style``'s first row) or a
    ``Tacotron`` (its reference embedding through the style attention over
    the tanh'd tokens, or the reference embedding without tokens)."""
    import torch

    from .models.tacotron import Tacotron
    if not isinstance(model, Tacotron):
        if not model.has_style:
            raise ValueError(f"system_type {model.system_type!r} has no "
                             "style encoder")
        return lambda mel: model.encode_style(mel)[0][:, 0]

    def embed(mel):
        ref = model.ref_encoder(mel, False)
        if not model.use_gst:
            return ref
        tokens = torch.tanh(model.style_tokens)[None].expand(
            mel.shape[0], -1, -1)
        return model.style_attention(ref[:, None], tokens)[:, 0]
    return embed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--weights", required=True, help="flat npz export")
    parser.add_argument("--model_kind", default="autoregressive",
                        choices=["autoregressive", "tacotron"])
    parser.add_argument("--metafile", default=None)
    parser.add_argument("--mel_dir", default=None)
    parser.add_argument("--out_dir", default="gst_embeddings")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from .data.dataset import load_files
    from .utils.config import load_config
    from .utils.precision import pin_float32
    pin_float32()
    config = load_config(args.config, args.model_kind)
    datadir = Path(config.get("train_data_directory")
                   or config["data_directory"])
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    samples, _ = load_files(args.metafile or datadir / "train_metafile.txt",
                            args.mel_dir or datadir / "mels", None)
    embed = style_embedder(load_model(args.config, args.model_kind,
                                      args.weights, args.device))
    with torch.no_grad():
        for _, _, mel_path, _ in samples:
            mel = torch.from_numpy(np.load(mel_path)[None]).to(args.device)
            np.save(out_dir / Path(mel_path).name,
                    embed(mel.float())[0].cpu().numpy())
    print(f"wrote {len(samples)} embeddings to {out_dir}")


if __name__ == "__main__":
    main()
