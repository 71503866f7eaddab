"""Tensor and sequence parallelism of the port on the CPU
(``etts_torch.parallel.tp``, the steps' ``mesh``): gloo ranks against one
process and against etts' single-device step, at etts' TINY widths
(tests/test_tensor_parallel.py) and its WaveRNN at rnn_dims 16.

  - The placements of ``tp_param_specs`` equal etts' ``tp_param_specs``
    parameter for parameter (through ``convert``'s names) on the forward,
    AR (GST style encoder) and WaveRNN models.
  - The forward, AR and WaveRNN train steps on a (data 1, model 2) mesh,
    and the forward step on (data 2, model 2), in float64 with the noise
    on: the loss, every gradient (shards gathered), every moved BatchNorm
    statistic and every updated parameter within GRAD_TOL of the tensor's
    largest magnitude of one process's, plus GRAD_ATOL for gradients that
    are zero in exact arithmetic (key biases under the softmax, conv
    biases before a BatchNorm), whose float64 noise is 1e-17 to 1e-20. A
    parameter whose gradient is such a zero moves by Adam's lr * g / (|g|
    + eps) of noise: it is held within one learning rate instead.
  - The same steps in float32 with the noise off against etts'
    single-device step on the same weights, at its bars (loss rtol 2e-4,
    an updated FFN kernel atol 3e-5).
  - The AR step on a (data 1, seq 2) mesh at the same bars, and
    ``train_autoregressive`` with ``sequence_parallel: 2`` on 2 ranks
    against the plain driver (which falls back to one process): the
    logged losses within 1e-5 relative, the zoo's MI within 1e-5.
  - A tensor-parallel state gathered to a checkpoint
    (``tp.full_state_dict``) loads into the unsharded state.
  - A head count or an FFN width the model axis does not divide raises.

Every rank is a process of its own with a timeout, a free port and one
thread (``tests/torch_tp_ranks.py``)."""
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_tp_ranks as tr

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
GRAD_TOL = 1e-5      # of the tensor's largest magnitude
GRAD_ATOL = 1e-12    # float64 noise of a gradient zero in exact arithmetic
LR = 1e-3            # the cases' learning rate


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(world: int, work: Path) -> list:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests/torch_tp_ranks.py"), "--port",
         str(port), "--rank", str(r), "--world", str(world), "--work",
         str(work)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results ({world: {rank: its npz}}), their outputs, the
    work dir and the single-process references ({case: results}),
    computed here while the ranks run."""
    from torch_parity import tiny_corpus
    work = tmp_path_factory.mktemp("tp")
    tiny_corpus(work / "sp_ws", sequence_parallel=2, dropout_rate=0.1)
    procs = {w: _ranks(w, work) for w in tr.CASES}
    try:
        refs = {c: tr.case(*c) for cases in tr.CASES.values()
                for c in cases}
        outs = {}
        for w, ps in procs.items():
            outs[w] = []
            for p in ps:
                out, _ = p.communicate(timeout=TIMEOUT)
                assert p.returncode == 0, out
                outs[w].append(out)
    finally:
        for p in [p for ps in procs.values() for p in ps]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = {w: {r: dict(np.load(work / f"rank{r}_of{w}.npz"))
               for r in range(w)} for w in tr.CASES}
    return res, outs, work, refs


def _etts_specs(kind: str) -> dict:
    """etts' placements of the kind's model, by the port's names:
    "col" (P(None, 'model') on a kernel, P('model') on a bias), "row"
    (P('model', None) on a kernel) , "vocab" (on an embedding) or "rep"."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from etts.models.autoregressive import AutoregressiveTransformer
    from etts.models.forward import ForwardTransformer
    from etts.models.wavernn import WaveRNN
    from etts.parallel.tp import tp_param_specs
    from etts_torch.convert import _torch_name
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "dropout": key, "prenet": key}
    if kind == "fwd":
        phon = jnp.ones((2, 10), jnp.int32)
        v = jax.eval_shape(lambda: ForwardTransformer(**tr.TINY).init(
            rngs, phon, jnp.ones((2, 10, 1)), max_frames=20))
    elif kind == "ar":
        v = jax.eval_shape(lambda: AutoregressiveTransformer(**tr.AR).init(
            rngs, jnp.ones((2, 6), jnp.int32), jnp.zeros((2, 5, 12)), None,
            r=2))
    else:
        m = WaveRNN(sample_rate=100, **tr.VOC)
        v = jax.eval_shape(lambda: m.init(key, jnp.zeros((2, 50)),
                                          jnp.zeros((2, 9, 8)), False))
    specs = tp_param_specs(v["params"])
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        name = _torch_name("".join(f"['{k}']" for k in keys))
        out[name] = {P(): "rep", P(None, "model"): "col", P("model"): "col",
                     P("model", None): "vocab" if keys[-1] == "embedding"
                     else "row"}[spec]
    return out


@pytest.mark.parametrize("kind", ["fwd", "ar", "voc"])
def test_placements_equal_etts(kind):
    from torch.distributed.tensor import Replicate, Shard
    from etts_torch.parallel.tp import tp_param_specs
    model = tr.build(kind, False)
    got = {}
    for name, spec in tp_param_specs(model).items():
        owner = model.get_submodule(name.rpartition(".")[0])
        if spec == Replicate():
            got[name] = "rep"
        elif isinstance(owner, torch.nn.Embedding):
            assert spec == Shard(0)
            got[name] = "vocab"
        else:
            got[name] = {0: "col", 1: "row"}[spec.dim]
    want = _etts_specs(kind)
    assert got == want
    assert set(got.values()) == ({"col", "rep"} if kind == "voc"
                                 else {"col", "row", "vocab", "rep"})


def _held(got: dict, want: dict, label: str, grads=None):
    """Every tensor of ``want`` (one process's) within GRAD_TOL of its
    largest magnitude plus GRAD_ATOL; a parameter whose gradient (in
    ``grads``, else ``want``) is zero in exact arithmetic within one
    learning rate."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        if k.startswith("param/"):
            g = (grads or want).get("grad/" + k[len("param/"):])
            if g is not None and float(np.abs(g).max()) < GRAD_ATOL:
                assert err <= LR, f"{label} {k}: {err:.3e}"
                continue
        scale = float(np.abs(w).max())
        assert err <= GRAD_TOL * scale + GRAD_ATOL, (
            f"{label} {k}: {err:.3e} of {scale:.3e}")


STEP_CASES = [(2, "fwd", "model"), (2, "ar", "model"), (2, "voc", "model"),
              (4, "fwd", "model"), (2, "ar", "seq")]


@pytest.mark.parametrize("world,kind,axis", STEP_CASES)
def test_step_equals_one_process(ranks, world, kind, axis):
    res, _, _, refs = ranks
    want = refs[(kind, axis, "f64")]
    assert any(k.startswith("stat/") for k in want)
    key = f"{kind}_{axis}_f64/"
    for r in range(world):
        got = {k[len(key):]: v for k, v in res[world][r].items()
               if k.startswith(key)}
        _held(got, want, f"rank {r} of {world}")


@functools.lru_cache
def _etts_step(kind: str):
    """etts' single-device step (float32, the noise off) on the weights
    the cases start from: (loss, {port name: updated parameter in the
    port's layout})."""
    import jax
    import jax.numpy as jnp
    from etts.models.autoregressive import AutoregressiveTransformer
    from etts.models.forward import ForwardTransformer
    from etts.models.wavernn import WaveRNN
    from etts.train import (TrainState, make_autoregressive_train_step,
                            make_forward_train_step, make_optimizer,
                            make_wavernn_train_step)
    from etts_torch.convert import export_flat
    from torch_parity import torch_grads, unflatten
    variables = unflatten(export_flat(tr.build(kind, False)))
    tx = make_optimizer([[0, LR]])
    state = TrainState.create(variables, tx)
    batch = tuple(jnp.asarray(x) for x in tr.global_batch(kind))
    key = jax.random.PRNGKey(0)
    if kind == "fwd":
        step = make_forward_train_step(
            ForwardTransformer(**tr.TINY, dropout_rate=0.0), tx,
            max_frames=tr.MAX_FRAMES)
        state, m = step(state, batch, key)
    elif kind == "ar":
        step = make_autoregressive_train_step(
            AutoregressiveTransformer(**tr.AR, dropout_rate=0.0), tx)
        state, m, _ = step(state, batch, jnp.zeros(()), key, r=tr.R,
                           prenet_dropout=0.0)
    else:
        step = make_wavernn_train_step(WaveRNN(sample_rate=100, **tr.VOC),
                                       tx)
        state, m = step(state, batch, key)
    return float(m["loss"]), torch_grads(state.params)


KERNEL = {"fwd": "encoder.SADB_0.ffn.d1.weight",
          "ar": "TextEncoder.SADB_0.ffn.d1.weight", "voc": "fc1.weight"}


@pytest.mark.parametrize("kind,axis", [("fwd", "model"), ("ar", "model"),
                                       ("voc", "model"), ("ar", "seq")])
def test_step_equals_etts(ranks, kind, axis):
    res, _, _, _ = ranks
    loss, params = _etts_step(kind)
    key = f"{kind}_{axis}_f32/"
    for r in range(2):
        got = res[2][r]
        np.testing.assert_allclose(float(got[key + "loss"]), loss, rtol=2e-4)
        np.testing.assert_allclose(got[key + "param/" + KERNEL[kind]],
                                   params[KERNEL[kind]], atol=3e-5)


def test_sequence_parallel_driver_equals_plain(ranks):
    from etts_torch.train_autoregressive import main
    from etts_torch.utils.config import ConfigManager
    from etts_torch.utils.logging import read_scalars
    _, outs, work, _ = ranks
    assert "sequence parallelism: data 1 x seq 2" in outs[2][0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks' thread count
    try:
        main(tr.driver_argv(work) + ["--session_name", "one"])
    finally:
        torch.set_num_threads(threads)
    one, two = (ConfigManager(work / "sp_ws", "autoregressive", s)
                for s in ("one", "sp"))
    a, b = read_scalars(one.log_dir), read_scalars(two.log_dir)
    mi = [t for t in a if t.startswith("mi/")]
    assert mi
    for tags, tol in ((("train/loss",), dict(rtol=1e-5)),
                      (mi, dict(atol=1e-5))):
        for tag in tags:
            steps = list(range(tr.STEPS))
            assert sorted(a[tag]) == sorted(b[tag]) == steps
            np.testing.assert_allclose([b[tag][s] for s in steps],
                                       [a[tag][s] for s in steps],
                                       err_msg=tag, **tol)
    assert (sorted(p.name for p in two.weights_dir.iterdir())
            == sorted(p.name for p in one.weights_dir.iterdir()))


def test_checkpoint_is_the_unsharded_format(ranks):
    from etts_torch.train.state import TrainState
    _, _, work, refs = ranks
    ckpt = torch.load(work / "tp_ckpt.pt", weights_only=False)
    state = TrainState(tr.build("fwd", True).double(), [[0, LR]])
    state.load_state_dict(ckpt)
    assert state.step == 1
    want = refs[("fwd", "model", "f64")]
    got = {f"param/{n}": t.detach().numpy()
           for n, t in state.module.state_dict().items()
           if not n.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))}
    _held(got, {k: v for k, v in want.items() if k.startswith("param/")},
          "checkpoint", want)
    for p in state.params:
        for k in ("exp_avg", "exp_avg_sq"):
            assert state.optimizer.state[p][k].shape == p.shape


class _Mesh:
    """A mesh's face for ``apply_tp_sharding``'s checks, no group."""
    mesh_dim_names = ("data", "model")

    def __init__(self, model: int):
        self.model = model

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0

    def size(self, dim=None):
        return (1, self.model)[dim]


@pytest.mark.parametrize("over,model,what", [
    ({}, 3, "heads"), (dict(encoder_feed_forward_dimension=65), 2, "FFN")])
def test_undivided_axis_raises(over, model, what):
    from etts_torch.models.forward import ForwardTransformer
    from etts_torch.parallel.tp import apply_tp_sharding
    with pytest.raises(ValueError, match=what):
        apply_tp_sharding(ForwardTransformer(**dict(tr.TINY, **over)),
                          _Mesh(model))
