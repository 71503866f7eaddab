"""The models' parameters, as names and shapes in the flax layout, and
their seeded values.

Every parameter is named by its path in the flax tree (``['A']['b']
['kernel']``), the layout ``etts_torch.convert.load_into`` reads; the
plain references read the same dict. The values are drawn on the device
from ``--seed`` in two calls (one normal draw, one uniform draw for the
BatchNorm variances) and cut into the parameters in the order of their
sorted names: matrices and kernels normal with std 1 / sqrt(fan in), a
GRU's recurrent kernel orthogonal (its rows orthonormal) and its biases
zero, as the models initialise their GRUs; other biases normal 0.02, norm
scales 1 + normal 0.02, running means normal 0.1,
running variances uniform in [0.5, 1.5]. ``overrides`` then sets the
entries a configuration assumes (``assumed`` in its file)."""
from __future__ import annotations

import math

import torch


def _k(*path) -> str:
    return "".join(f"['{p}']" for p in path)


class Spec:
    """{keystr: (shape, kind)}; kind is kernel, recurrent, zero, bias,
    scale, mean or var."""

    def __init__(self):
        self.entries: dict = {}

    def dense(self, path, n_in, n_out, bias=True):
        self.entries[_k(*path, "kernel")] = ((n_in, n_out), "kernel")
        if bias:
            self.entries[_k(*path, "bias")] = ((n_out,), "bias")

    def conv(self, path, k, n_in, n_out, bias=True):
        self.entries[_k(*path, "kernel")] = ((*k, n_in, n_out), "kernel")
        if bias:
            self.entries[_k(*path, "bias")] = ((n_out,), "bias")

    def norm(self, path, n, batch: bool):
        self.entries[_k(*path, "scale")] = ((n,), "scale")
        self.entries[_k(*path, "bias")] = ((n,), "bias")
        if batch:
            self.entries["batch_stats:" + _k(*path, "mean")] = ((n,), "mean")
            self.entries["batch_stats:" + _k(*path, "var")] = ((n,), "var")

    def raw(self, path, shape, kind="kernel"):
        self.entries[_k(*path)] = (tuple(shape), kind)

    def mha(self, path, d, q_dim, kv_dim):
        for w, n_in in (("wq", q_dim), ("wk", kv_dim), ("wv", kv_dim)):
            self.dense((*path, w), n_in, d)
        self.dense((*path, "dense"), q_dim + d, d)

    def self_block(self, path, d, hidden):
        self.mha((*path, "sarn", "mha"), d, d, d)
        self.norm((*path, "sarn", "ln"), d, False)
        self.norm((*path, "sarn", "last_ln"), d, False)
        self.ffn((*path, "ffn"), d, hidden)

    def ffn(self, path, d, hidden):
        self.dense((*path, "d1"), d, hidden)
        self.dense((*path, "d2"), hidden, d)
        self.norm((*path, "ln"), d, False)
        self.norm((*path, "last_ln"), d, False)

    def cnn_resnorm(self, path, c_in, c_out, n_layers, hidden, k, batch):
        c = c_in
        for i in range(n_layers - 1):
            self.conv((*path, f"conv_{i}"), (k,), c, hidden)
            self.norm((*path, f"norm_{i}"), hidden, batch)
            c = hidden
        self.conv((*path, "last_conv"), (k,), c, c_out)
        self.norm((*path, "norm_last"), c_out, batch)
        self.norm((*path, "norm_out"), c_out, batch)


def vocab_size(alphabet: str, start_end: bool) -> int:
    return len(alphabet) + 1 + (2 if start_end else 0)


def ar_spec(c: dict, alphabet: str) -> Spec:
    """The GST-TransformerTTS of ``system_type`` speaker_style_text with
    dense blocks only."""
    s = Spec()
    d_enc, d_dec = c["encoder_model_dimension"], c["decoder_model_dimension"]
    s.raw(("TextEmbedding", "embedding"), (vocab_size(alphabet, True), d_enc))
    for i in range(len(c["encoder_num_heads"])):
        s.self_block(("TextEncoder", f"SADB_{i}"), d_enc,
                     c["encoder_feed_forward_dimension"])
    m, ch = c["mel_channels"], 1
    k = c["ref_encoder_kernel_size"]
    for i, f in enumerate(c["ref_encoder_filters"]):
        s.conv(("RefEncoderGST", f"conv_{i}"), (k, k), ch, f)
        s.norm(("RefEncoderGST", f"bn_{i}"), f, True)
        ch, m = f, -(-m // c["ref_encoder_strides"])
    g = c["ref_encoder_gru_cell_units"]
    s.raw(("RefEncoderGST", "gru_wi"), (m * ch, 3 * g))
    s.raw(("RefEncoderGST", "gru_wh"), (g, 3 * g), "recurrent")
    s.raw(("RefEncoderGST", "gru_bi"), (3 * g,), "zero")
    s.raw(("RefEncoderGST", "gru_bh"), (3 * g,), "zero")
    s.dense(("RefEncoderGST", "rnn_proj"), g, g)
    style, heads = c["gst_style_embed_dim"], c["gst_multi_num_heads"]
    s.raw(("RefEncoderGST", "gst_tokens"), (c["gst_heads"], style // heads))
    s.mha(("RefEncoderGST", "mha"), style, g, style // heads)
    enc_dim = d_enc + style + c["speaker_embed_dim"]
    s.dense(("DecoderPrenet", "d1"), c["mel_channels"],
            c["decoder_prenet_dimension"])
    s.dense(("DecoderPrenet", "d2"), c["decoder_prenet_dimension"], d_dec)
    for i in range(len(c["decoder_num_heads"])):
        p = ("Decoder", f"CADB_{i}")
        s.mha((*p, "sarn", "mha"), d_dec, d_dec, d_dec)
        s.norm((*p, "sarn", "ln"), d_dec, False)
        s.norm((*p, "sarn", "last_ln"), d_dec, False)
        s.mha((*p, "carn", "mha"), d_dec, d_dec, enc_dim)
        s.norm((*p, "carn", "layernorm"), d_dec, False)
        s.ffn((*p, "ffn"), d_dec, c["decoder_feed_forward_dimension"])
    max_r = c["reduction_factor_schedule"][0][1]
    s.dense(("FinalProj",), d_dec, c["mel_channels"] * max_r)
    s.dense(("Postnet", "stop_linear"), c["mel_channels"], 3)
    s.cnn_resnorm(("Postnet", "conv_blocks"), c["mel_channels"],
                  c["mel_channels"], c["postnet_conv_layers"],
                  c["postnet_conv_filters"], c["postnet_kernel_size"], True)
    return s


def wavernn_spec(c: dict) -> Spec:
    s = Spec()
    feat, comp, res = c["mel_channels"], c["voc_compute_dims"], c["voc_res_out_dims"]
    d, fc, aux = c["voc_rnn_dims"], c["voc_fc_dims"], c["voc_res_out_dims"] // 4
    r = ("upsample", "resnet")
    s.conv((*r, "Conv_0"), (2 * c["voc_pad"] + 1,), feat, comp, bias=False)
    s.norm((*r, "BatchNorm_0"), comp, True)
    for i in range(c["voc_res_blocks"]):
        for j in (0, 1):
            s.conv((*r, f"res_{i}", f"Conv_{j}"), (1,), comp, comp, bias=False)
            s.norm((*r, f"res_{i}", f"BatchNorm_{j}"), comp, True)
    s.conv((*r, "Conv_1"), (1,), comp, res)
    for i, f in enumerate(c["voc_upsample_factors"]):
        s.conv(("upsample", f"smooth_{i}"), (1, 2 * f + 1), 1, 1, bias=False)
    s.dense(("I",), feat + aux + 1, d)
    for name, n_in in (("rnn1", d), ("rnn2", d + aux)):
        s.raw((f"{name}_wi",), (n_in, 3 * d))
        s.raw((f"{name}_wh",), (d, 3 * d), "recurrent")
        s.raw((f"{name}_bi",), (3 * d,), "zero")
        s.raw((f"{name}_bh",), (3 * d,), "zero")
    s.dense(("fc1",), d + aux, fc)
    s.dense(("fc2",), fc + aux, fc)
    s.dense(("fc3",), fc, 30)
    return s


def forward_spec(c: dict, alphabet: str) -> Spec:
    s = Spec()
    d = c["encoder_model_dimension"]
    s.raw(("embedding", "embedding"), (vocab_size(alphabet, False), d))
    for i in range(len(c["encoder_num_heads"])):
        s.self_block(("encoder", f"SADB_{i}"), d,
                     c["encoder_feed_forward_dimension"])
    s.cnn_resnorm(("dur_pred", "conv_blocks"), d, d, 2, d, 3, False)
    s.dense(("dur_pred", "linear"), d, 1)
    s.dense(("decoder_prenet", "d1"), d, c["decoder_feed_forward_dimension"])
    s.dense(("decoder_prenet", "d2"), c["decoder_feed_forward_dimension"],
            c["decoder_model_dimension"])
    for i in range(len(c["decoder_num_heads"])):
        s.self_block(("decoder", f"SADB_{i}"), c["decoder_model_dimension"],
                     c["decoder_feed_forward_dimension"])
    s.dense(("out",), c["decoder_model_dimension"], c["mel_channels"])
    s.cnn_resnorm(("decoder_postnet",), c["mel_channels"], c["mel_channels"],
                  c["postnet_conv_layers"], c["postnet_conv_filters"],
                  c["postnet_kernel_size"], True)
    return s


def draw(spec: Spec, seed: int, device, overrides=()) -> dict:
    """{keystr: float32 tensor on ``device``} from ``seed``."""
    names = sorted(spec.entries)
    sizes = [math.prod(spec.entries[n][0]) for n in names]
    gen = torch.Generator(device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, n in zip(names, sizes):
        shape, kind = spec.entries[name]
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            out[name] = z * (math.prod(shape[:-1]) ** -0.5)
        elif kind == "recurrent":
            out[name] = orthogonal(z)
        elif kind == "zero":
            out[name] = torch.zeros_like(z)
        elif kind == "bias":
            out[name] = z * 0.02
        elif kind == "scale":
            out[name] = 1.0 + z * 0.02
        elif kind == "mean":
            out[name] = z * 0.1
        else:
            out[name] = 0.5 + u
    for o in overrides:
        apply_override(out, o)
    return out


def orthogonal(z):
    """The orthogonal matrix of a normal draw z (rows, cols), as
    ``torch.nn.init.orthogonal_`` makes it: the Q of the QR of z (or of
    its transpose, the longer side first), its columns signed by R's
    diagonal."""
    a = z.T if z.shape[0] < z.shape[1] else z
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None]
    return q.T.contiguous() if z.shape[0] < z.shape[1] else q


def apply_override(params: dict, o: dict):
    """{"key": keystr, "value": v or "scale": s, optional "index": [i, j]
    a slice of the last axis}: set that part of a parameter to a constant,
    or multiply it by one."""
    x = params[o["key"]]
    part = x[..., o["index"][0]:o["index"][1]] if "index" in o else x
    if "scale" in o:
        part.mul_(o["scale"])
    else:
        part.fill_(o["value"])


def to_host(params: dict) -> dict:
    """The dict as numpy, one copy to the host."""
    names = list(params)
    flat = torch.cat([params[n].reshape(-1) for n in names]).cpu().numpy()
    out, at = {}, 0
    for n in names:
        k = params[n].numel()
        out[n] = flat[at:at + k].reshape(tuple(params[n].shape))
        at += k
    return out
