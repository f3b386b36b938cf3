"""The port's checkpoints and its auto-resuming trainer on the CPU: the
atomic npz round trip (bf16 bit for bit, the int32 step), keep-K garbage
collection, the trainer's crash and resume (bit-identical to the run that
did not crash), the straggler watermark, and the train CLI with its resume
(``--device cpu``).  The reference's own tests of these are
``tests/test_checkpoint_fault.py``; the port's checkpoints hold its own
state, so nothing here needs JAX."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import main
from repro_torch.models import build_model
from repro_torch.train import OptConfig, Trainer, TrainerConfig


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of tiny torch ops: one intra-op thread a worker while this
    module runs (the suite runs six workers); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree():
    g = torch.Generator().manual_seed(0)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-40,
                            3.0e38, -1.5], dtype=torch.float32).bfloat16()
    return {"params": {"blocks.0.ln1.w": torch.randn(4, generator=g).bfloat16(),
                       "embed.w": torch.randn(3, 4, generator=g)},
            "opt": {"mu": {"embed.w": torch.randn(3, 4, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)},
            "special": special, "ids": torch.arange(5)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_roundtrip_is_bitwise(tmp_path):
    """A nested state of float32, bf16 (specials and a subnormal
    included), int32 and int64 comes back bit for bit in ``like``'s
    dtypes, under ``//``-joined keys, and the atomic write leaves no
    ``.tmp`` behind."""
    tree = _tree()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree)
    assert not os.path.exists(path + ".tmp")
    with np.load(path) as data:
        assert set(data.files) == {"params//blocks.0.ln1.w@bf16", "params//embed.w",
                                   "opt//mu//embed.w", "opt//step", "special@bf16", "ids"}
        assert data["special@bf16"].dtype == np.uint16
    out = load_checkpoint(path, tree)

    def same(a, b, key):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), key
            for k in a:
                same(a[k], b[k], f"{key}/{k}")
            return
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(_bits(a), _bits(b)), key

    same(tree, out, "")


def test_restore_takes_like_dtype(tmp_path):
    """A float32 checkpoint restored into a bf16 ``like`` comes back in
    bf16 (rounded once), and an int32 step stays int32 0-d."""
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"w": torch.tensor([1.0, 1.0 + 2.0**-9, 3.0]),
                           "step": torch.tensor(3, dtype=torch.int32)})
    out = load_checkpoint(path, {"w": torch.zeros(3, dtype=torch.bfloat16),
                                 "step": torch.zeros((), dtype=torch.int32)})
    assert out["w"].dtype == torch.bfloat16 and out["w"].tolist() == [1.0, 1.0, 3.0]
    assert out["step"].dtype == torch.int32 and out["step"].shape == () and int(out["step"]) == 3


def test_keep_k_gc(tmp_path):
    """Keep-K with the newest always kept, ``latest`` and
    ``restore_latest``."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest() is None and mgr.restore_latest({"x": torch.zeros(2)})[0] is None
    for s in (10, 20, 30, 40):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.steps() == [30, 40]
    assert mgr.latest() == 40
    step, tree = mgr.restore_latest({"x": torch.zeros(2)})
    assert step == 40 and tree["x"].tolist() == [40.0, 40.0]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000030.npz", "ckpt_00000040.npz"]


def _trainer(path, steps, resume="auto"):
    """The reference's crash/resume trainer (tests/test_checkpoint_fault.py):
    the LLaMA smoke config in float32, 2 x 32 tokens, a checkpoint every 5
    steps."""
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    model = build_model(cfg, device="cpu")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    return Trainer(model, data_cfg, OptConfig(lr=1e-3, total_steps=steps),
                   TrainerConfig(total_steps=steps, ckpt_every=5, ckpt_dir=str(path), keep=5,
                                 resume=resume))


def test_crash_resume_bitexact(tmp_path):
    """An uninterrupted 12-step run ≡ a run that crashes at step 7 and a
    new trainer that resumes from the step-5 checkpoint: the final loss,
    parameters and AdamW state are bit-identical on the CPU (the reference
    holds the loss to rel 1e-5)."""
    ref = _trainer(tmp_path / "ref", 12, resume="none").run(0)
    assert ref["resumed_from"] == 0 and len(ref["metrics"]) == 12
    with pytest.raises(RuntimeError, match="simulated node failure at step 7"):
        _trainer(tmp_path / "crash", 12).run(0, crash_at=7)
    assert CheckpointManager(str(tmp_path / "crash")).steps() == [5]
    out = _trainer(tmp_path / "crash", 12).run(0)
    assert out["resumed_from"] == 5 and len(out["metrics"]) == 7
    assert out["metrics"][-1]["loss"] == ref["metrics"][-1]["loss"]
    for part in ("params", "opt"):
        a, b = ref["state"][part], out["state"][part]
        for k in ("mu", "nu") if part == "opt" else (None,):
            x, y = (a, b) if k is None else (a[k], b[k])
            assert all(torch.equal(x[n], y[n]) for n in x), (part, k)
    assert int(out["state"]["opt"]["step"]) == 12


def test_straggler_watermark(tmp_path):
    """A step slower than ``straggler_factor`` times the median of the last
    50 is flagged, from the fifth step on."""
    t = _trainer(tmp_path, 1)
    flags = [t._straggler(dt) for dt in (1.0, 5.0, 1.0, 1.0, 1.0, 1.0, 2.5, 1.9)]
    assert flags == [False, False, False, False, False, False, True, False]


def test_train_cli_resumes(tmp_path, capsys):
    """``launch/train.py --device cpu`` with ``--sparse-train``: rc 0, the
    reference's log and ``done:`` lines; run again with more steps, it
    resumes from the last checkpoint."""
    argv = ["--arch", "llama31_8b", "--smoke", "--batch", "2", "--seq", "16", "--sparsity",
            "8:16", "--sparse-train", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert main(argv + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("step     0 loss ") and "(resumed_from=0)" in out
    assert "done: first loss " in out and " → last " in out
    assert main(argv + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "(resumed_from=4)" in out and "step     0" not in out
    assert CheckpointManager(str(tmp_path)).steps() == [2, 4, 6]
