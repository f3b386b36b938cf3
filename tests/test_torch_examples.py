"""The port's four examples (``examples/torch_*.py``) held to the JAX
examples they mirror, on the CPU, with the JAX examples' weights carried
over (``weights.from_jax_params``) and their inputs.

Each JAX example's ``main()`` runs as it is, with its ``build_model``
wrapped so that ``init`` hands out the weights it makes (and, for the
serving and training examples, its engine or trainer wrapped so that the
results are kept); its printed numbers are read from its output.  The
inputs are the JAX examples' own (``jax.random`` draws with their keys, and
the JAX data pipeline's batches), handed to the port's ``run``:

* quickstart: 2:4 sparsity 0.50 in both; the output perturbation at 2:4,
  4:8 and 8:16 within 1e-4 of the printed four decimals (float32 products
  in another order);
* serving: the greedy tokens of the dense and the Amber 8:16 engines equal;
* deployment: the q/gate skip list and the coverage equal, the outlier
  ratio equal to its printed decimal, the two rewrites' relative errors
  within 1e-4 of the printed four decimals;
* training: six steps' losses within rel 1e-4 (``tests/test_torch_train.py``'s
  tolerance for free-running steps), and a second run to eight steps that
  resumes from step 6 in both, its losses within the same.

The port counts its Robust-Norm scales per layer (12 for the 4-layer smoke
model) where the JAX example counts its scan-stacked leaves (7); that line
is not compared.
"""
import contextlib
import dataclasses
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import calibration_stream as j_calibration_stream
from repro.data.pipeline import lm_batch as j_lm_batch
from repro_torch.configs import get_smoke_config as tget
from repro_torch.weights import from_jax_params

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
QUIET = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs six
    workers); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(mod, argv=("example",)):
    """``mod.main()`` with ``build_model`` wrapped to keep the weights its
    models make → (printed output, [weights])."""
    made, build = [], mod.build_model

    def recording(cfg):
        model = build(cfg)
        init = model.init

        def keep(key):
            made.append(init(key))
            return made[-1]

        object.__setattr__(model, "init", keep)
        return model

    mod.build_model = recording
    out, old = io.StringIO(), sys.argv
    sys.argv = list(argv)
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
        mod.build_model = build
    return out.getvalue(), made


def _port(arch, params, **kw):
    cfg = dataclasses.replace(tget(arch), dtype="float32", **kw)
    return from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _numbers(pattern, text):
    return [float(x) for x in re.findall(pattern, text)]


def test_quickstart_matches_the_jax_example():
    text, made = _run_jax(_load("quickstart"))
    cfg = jget("llama31_8b")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, cfg.d_model)))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 32), 0, cfg.vocab_size))
    got = _load("torch_quickstart").run(params=_port("llama31_8b", made[0]), x=x,
                                        tokens=tokens, **QUIET)
    want = _numbers(r"prefill — output perturbation ([0-9.]+)", text)
    assert len(want) == 3 and "sparsity: 0.50" in text
    assert got["sparsity"] == pytest.approx(0.5)
    for (ratio, err), w in zip(sorted(got["errors"].items()), want):
        assert abs(err - w) <= 1e-4, (ratio, err, w)
    assert got["errors"][(8, 16)] < got["errors"][(2, 4)]


def test_serve_example_emits_the_jax_examples_tokens():
    mod = _load("serve_sparse_prefill")
    outputs, engine = [], mod.ServingEngine

    class Keep(engine):
        def generate(self, *a, **k):
            outputs.append(super().generate(*a, **k))
            return outputs[-1]

    mod.ServingEngine = Keep
    try:
        text, made = _run_jax(mod)
    finally:
        mod.ServingEngine = engine
    cfg = jget("qwen2_7b")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 96), 0, cfg.vocab_size))
    got = _load("torch_serve_sparse_prefill").run(params=_port("qwen2_7b", made[0]),
                                                  tokens=tokens, **QUIET)
    dense, sparse = (np.asarray(o["tokens"]) for o in outputs[-2:])
    np.testing.assert_array_equal(got["dense"].numpy(), dense)
    np.testing.assert_array_equal(got["amber816"].numpy(), sparse)
    assert f"greedy agreement (dense vs sparse prefill): {got['agreement']:.3f}" in text


def test_deploy_example_matches_the_jax_example():
    text, made = _run_jax(_load("deploy_outstanding_sparse"))
    cfg = jget("llama31_8b")
    k = jax.random.PRNGKey
    tokens = np.asarray(jax.random.randint(k(1), (2, 24), 0, cfg.vocab_size))
    x = np.asarray(jax.random.normal(k(2), (128, cfg.d_model))
                   * (1 + 10 * (jnp.arange(cfg.d_model) < 4)))
    w = np.asarray(jax.random.normal(k(3), (cfg.d_model, cfg.d_ff)) * cfg.d_model**-0.5)
    calib = [np.asarray(b["tokens"]) for b in j_calibration_stream(
        JDataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2), 4)]
    got = _load("torch_deploy_outstanding_sparse").run(
        params=_port("llama31_8b", made[0]), tokens=tokens, x=x, w=w, calib=calib, **QUIET)
    assert f"selected q/gate skip layers: {got['skips']} → coverage {got['coverage']:.1%}" \
        in text
    assert f"max outlier ratio {got['outlier_ratio']:.1f}x" in text
    want = _numbers(r"rel_err=([0-9.]+)", text)
    assert len(want) == 2
    for got_err, w_err in zip(got["rel_err"].values(), want):
        assert abs(got_err - w_err) <= 1e-4


def test_train_example_matches_the_jax_example_and_resumes(tmp_path):
    mod = _load("train_sparse_lm")
    runs, trainer = [], mod.Trainer

    class Keep(trainer):
        def run(self, *a, **k):
            runs.append(super().run(*a, **k))
            return runs[-1]

    mod.Trainer = Keep
    try:
        _, made = _run_jax(mod, ["x", "--steps", "6", "--ckpt-dir", str(tmp_path / "j")])
        text, _ = _run_jax(mod, ["x", "--steps", "8", "--ckpt-dir", str(tmp_path / "j")])
    finally:
        mod.Trainer = trainer
    assert "resumed_from=6" in text
    cfg = jget("llama31_8b")
    data = JDataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    batches = lambda step: np.asarray(j_lm_batch(data, step)["tokens"])
    ex = _load("torch_train_sparse_lm")
    params = _port("llama31_8b", made[0], n_layers=4)
    first = ex.run(6, str(tmp_path / "t"), params=params, batches=batches, **QUIET)
    again = ex.run(8, str(tmp_path / "t"), params=_port("llama31_8b", made[0], n_layers=4),
                   batches=batches, **QUIET)
    assert (first["resumed_from"], again["resumed_from"]) == (0, 6)
    for got, want in ((first, runs[0]), (again, runs[1])):
        losses = [m["loss"] for m in got["metrics"]]
        assert losses == pytest.approx([m["loss"] for m in want["metrics"]], rel=1e-4)
