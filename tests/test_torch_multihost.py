"""Data parallelism of the port on the CPU (``etts_torch.parallel``): two
gloo ranks against one process on the same global batch.

  - The port's worker (``python -m etts_torch.parallel._multihost_worker``,
    a forward-model step, dropout on): the ranks agree at rtol 1e-6 and
    match one process at 2e-4 (tests/test_multihost.py's bars); with
    ``--ckpt_dir`` rank 0 alone writes the checkpoint and the log, and
    both ranks continue alike from it.
  - One AR step at test width with the GST reference encoder's and the
    postnet's BatchNorm, dropout, prenet dropout and HeadDrop, with the
    MINE zoo updated on the step's embeddings (float32), and with the
    zoo's estimate in the tape (``mine_adversarial``, float64): every
    gradient after the all-reduce, every moved BatchNorm statistic and the
    gradients of the zoo's update within 1e-5 of the tensor's largest
    magnitude of one process's (``tests/torch_dp_ranks.py``), plus 1e-7
    for the gradients that are zero in exact arithmetic (the attention's
    key biases under the softmax, conv biases before a BatchNorm on batch
    statistics). In float32 such a zero is rounding noise of the size of
    the terms that cancel: 1e-10 to 1e-9 for the key biases, but one ulp
    of 1.0 (2.4e-7) for the MINE critic's output bias, whose gradient is
    1 - 1 (``torch_dp_ranks.DTYPES``).
  - One WaveRNN step (BatchNorm in its upsample network) and one
    GST-Tacotron step (BatchNorm, the prenets' and zoneout's uniforms,
    global-norm clipping), both in float64, at the same bars: their
    float32 gradients carry rounding noise past the bar.
  - ``generate_batch_sharded`` on 2 ranks with peaky RAW weights against
    etts' ``generate_batch_sharded`` on its 8-device CPU mesh (scan path).
  - ``train_autoregressive`` (dropout and the MINE zoo),
    ``train_wavernn`` and ``train_tacotron`` with ``--multihost`` on 2
    ranks against one process, which runs at the ranks' one thread: the
    logged losses within 1e-5 relative, the zoo's MI estimates within
    1e-5; rank 0 alone logs and saves.

Every rank is a process of its own with a timeout and a free port, so
that no process group lives in the test process."""
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dp_ranks as dp

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
GRAD_TOL = 1e-5      # of the tensor's largest magnitude
GRAD_ATOL = 1e-7     # torch_parity.assert_step_close's, for exact zeros


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def _spawn(args):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(procs) -> list:
    """Each process's output; all are killed if one fails or hangs."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, out
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _worker(port, pid, nprocs, *extra):
    return _spawn(["-m", "etts_torch.parallel._multihost_worker", "--port",
                   str(port), "--process_id", str(pid), "--num_processes",
                   str(nprocs), *extra])


def _value(tag, out) -> float:
    m = re.search(rf"{tag} ([-\d.einf]+)", out)
    assert m, f"no {tag} in output:\n{out}"
    return float(m.group(1))


def test_worker_two_ranks_match_one_process():
    port = _free_port()
    procs = [_worker(_free_port(), 0, 1)] + [_worker(port, r, 2)
                                             for r in (0, 1)]
    one, *two = [_value("MULTIHOST_LOSS", o) for o in _finish(procs)]
    np.testing.assert_allclose(two[0], two[1], rtol=1e-6)
    np.testing.assert_allclose(two[0], one, rtol=2e-4)


def test_worker_checkpoint_across_ranks(tmp_path):
    ckpt = tmp_path / "ckpts"
    port = _free_port()
    outs = _finish([_worker(port, r, 2, "--ckpt_dir", str(ckpt))
                    for r in (0, 1)])
    resume = [_value("MULTIHOST_RESUME_LOSS", o) for o in outs]
    np.testing.assert_allclose(resume[0], resume[1], rtol=1e-6)
    assert sorted(p.name for p in ckpt.iterdir() if p.is_file()) == [
        "ckpt-1.pt"]
    # one writer: one line of one log
    assert [p.name for p in (ckpt / "logs").iterdir()] == ["scalars.jsonl"]
    assert len((ckpt / "logs/scalars.jsonl").read_text().splitlines()) == 1


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two ranks of tests/torch_dp_ranks.py on the inputs written here:
    ({rank: its results}, the work dir, the peaky vocoder pair and
    mels)."""
    from torch_parity import (TACO_TINY, VOC_TINY, taco_workspace,
                              tiny_corpus, voc_pair, voc_store)
    work = tmp_path_factory.mktemp("dp")
    jm, v, tm = voc_pair("RAW", peaky=1e5)
    torch.save({"kwargs": VOC_TINY, "taco_kwargs": TACO_TINY,
                "state": tm.state_dict()}, work / "voc.pt")
    rng = np.random.default_rng(3)
    mels = {f"m{i}": rng.uniform(0, 1, (n, 8)).astype(np.float32)
            for i, n in enumerate((12, 7, 15))}
    np.savez(work / "mels.npz", **mels)
    tiny_corpus(work / "ar_ws", dropout_rate=0.1,
                head_drop_schedule=[[0, 1]],
                decoder_prenet_dropout_schedule=[[0, 0.5]])
    (work / "voc_ws").mkdir()
    voc_store(work / "voc_ws")
    (work / "taco_ws").mkdir()
    taco_workspace(work / "taco_ws")
    port = _free_port()
    _finish([_spawn([str(ROOT / "tests/torch_dp_ranks.py"), "--port",
                     str(port), "--rank", str(r), "--work", str(work)])
             for r in (0, 1)])
    res = {r: dict(np.load(work / f"rank{r}.npz")) for r in (0, 1)}
    return res, work, (jm, v, tm), list(mels.values())


def _close(got, want, label):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= GRAD_TOL * scale + GRAD_ATOL, (
        f"{label}: {err:.3e} of {scale:.3e}")


def _held(res, kind, want):
    """Each rank's results of ``kind`` against one process's ``want``."""
    got = [{k[len(kind) + 1:]: v for k, v in res[r].items()
            if k.startswith(kind + "/")} for r in (0, 1)]
    assert set(got[0]) == set(got[1]) == set(want)
    for r in (0, 1):
        for k, w in want.items():
            _close(got[r][k], w, f"rank {r} {kind} {k}")
    np.testing.assert_array_equal(got[0]["loss"], got[1]["loss"])


@pytest.mark.parametrize("kind", ["mine", "adversarial"])
def test_ar_step_two_ranks_equal_one_process(ranks, kind):
    res, _, _, _ = ranks
    want = dp.ar_case(kind)
    assert any(k.startswith("stat/RefEncoderGST.bn_") for k in want)
    _held(res, kind, want)
    if kind == "adversarial":
        assert float(want["mi_live"]) != 0.0


@pytest.mark.parametrize("kind", ["voc", "taco"])
def test_step_two_ranks_equal_one_process(ranks, kind):
    res, work, _, _ = ranks
    want = dp.step_case(kind, work)
    assert any(k.startswith("stat/") for k in want)
    _held(res, kind, want)


def test_generate_batch_sharded_matches_etts(ranks):
    import jax
    import jax.numpy as jnp
    from etts.models.wavernn import generate_batch_sharded as j_sharded
    from etts.parallel import make_mesh
    res, _, (jm, v, _), mels = ranks
    want = j_sharded(jm, v, [jnp.asarray(m) for m in mels],
                     mesh=make_mesh(("data",)), target=30, overlap=10,
                     mu_law=True, key=jax.random.PRNGKey(0),
                     use_pallas=False)
    assert len(jax.devices()) == 8
    for r in (0, 1):
        for i, (m, w) in enumerate(zip(mels, want)):
            got = res[r][f"wav/{i}"]
            assert got.shape == ((len(m) - 1) * 10,) == np.shape(w)
            np.testing.assert_allclose(got, np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("kind", ["ar", "voc", "taco"])
def test_driver_two_ranks_equal_one_process(ranks, kind):
    import importlib
    from etts_torch.utils.config import ConfigManager
    from etts_torch.utils.logging import read_scalars
    _, work, _, _ = ranks
    module = importlib.import_module(f"etts_torch.{dp.DRIVERS[kind]}")
    # at the ranks' thread count (``_env``): the CPU kernels' summation
    # order follows the threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        module.main(dp.driver_argv(work, kind) + ["--session_name", "one"])
    finally:
        torch.set_num_threads(threads)
    model_kind = {"ar": "autoregressive", "voc": "wavernn",
                  "taco": "tacotron"}[kind]
    one, two = (ConfigManager(work / f"{kind}_ws", model_kind, s)
                for s in ("one", "dp"))
    a, b = read_scalars(one.log_dir), read_scalars(two.log_dir)
    # the losses relative; the zoo's MI estimates, differences of two
    # means near zero, absolute (their float32 noise grows through the
    # zoo's Adam steps: 2.5e-6 at step 2)
    mi = [f"mi/MINE_{i}" for i in range(3)] if kind == "ar" else []
    for tags, tol in ((("train/loss",), dict(rtol=1e-5)),
                      (mi, dict(atol=1e-5))):
        for tag in tags:
            steps = list(range(dp.STEPS))
            assert sorted(a[tag]) == sorted(b[tag]) == steps
            np.testing.assert_allclose([b[tag][s] for s in steps],
                                       [a[tag][s] for s in steps],
                                       err_msg=tag, **tol)
    # rank 0 alone logged and saved: the same files as one process
    assert sorted(p.name for p in two.log_dir.iterdir()) == sorted(
        p.name for p in one.log_dir.iterdir())
    assert (sorted(p.name for p in two.weights_dir.iterdir())
            == sorted(p.name for p in one.weights_dir.iterdir()))
