"""The port's serving CLI (``python -m repro_torch.launch.serve``) against the
JAX package's (``python -m repro.launch.serve``), at the LLaMA-3.1 smoke
config on the CPU (``--device cpu``), and at the MoE, dense-variant and
recurrent architectures' smoke configs.

Both CLIs draw arrival gaps and prompt lengths from
``numpy.random.default_rng(--seed)`` in the same order; the prompt tokens
and the random weights differ (the port takes its prompts from the same
numpy generator, the JAX CLI from ``jax.random``).  With no EOS the
scheduling does not depend on token values, so every counter of the
``--trace`` report — per-request iterations, terminal states, lifecycle,
``# traces:``, dispatches, the paged pool and the prefix cache — must be
the JAX CLI's exactly.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch.serve import main as jax_main
from repro_torch.launch.serve import main

ROOT = Path(__file__).resolve().parents[1]
TRACE = ["--smoke", "--arch", "llama31_8b", "--trace", "--num-requests", "4", "--rate",
         "0.7", "--len-range", "6:20", "--slots", "2", "--chunk", "8", "--new-tokens", "5"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's smoke engines run thousands of tiny torch ops: with the
    suite's six workers, torch's intra-op thread pools oversubscribe the
    cores and slow them.  One thread a worker while this module runs;
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _report(out: str):
    """The counters of a ``--trace`` report: per-request rows without the
    wall-clock column, and the counts of each ``#`` line, keyed by its
    label (throughput: tokens and iterations; the paged line: before its
    backend's name; the JAX CLI's router line is left out)."""
    rows, lines = [], {}
    for line in out.splitlines():
        if line and line[0].isdigit():
            f = line.split(",")
            rows.append(f[:7] + f[8:])
        elif line.startswith("# ") and ":" in line:
            label, rest = line[2:].split(":", 1)
            if label == "throughput":
                rest = re.search(r"\d+ tokens", rest).group() + re.search(
                    r"over \d+ iterations", rest).group()
            if label != "replicas":
                lines[label] = re.findall(r"[a-z_]+=\d+|\d+", rest.split("attention=")[0])
    return rows, lines


VARIANTS = ("qwen2_5_32b", "chatglm3_6b", "stablelm_3b", "granite_34b")


@pytest.mark.parametrize("extra", [[], ["--no-fused-step"], ["--shared-prefix", "16"],
                                   ["--num-blocks", "3"], ["--arch", "qwen3_30b_a3b"]]
                         + [["--arch", arch] for arch in VARIANTS],
                         ids=["fused", "legacy", "shared-prefix", "small-pool", "moe",
                              *VARIANTS])
def test_trace_report_matches_jax_cli(capsys, extra):
    """``--trace`` returns 0, reports no negative latency, the fused path
    one program per work iteration, and the JAX CLI's counters: the
    same ``# traces:`` keys (each 1), dispatches, terminal states, paged
    pool and prefix-cache lines, and per-request rows."""
    assert jax_main(TRACE + extra) == 0
    want = capsys.readouterr().out
    assert main(TRACE + extra + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    rows, lines = _report(got)
    assert rows and all(float(line.split(",")[7]) >= 0.0 for line in got.splitlines()
                        if line and line[0].isdigit())
    assert rows == _report(want)[0]
    jlines = _report(want)[1]
    for label in ("throughput", "terminal states", "lifecycle", "traces", "dispatches",
                  "paged KV", "prefix cache"):
        assert lines[label] == jlines[label], label
    assert set(re.findall(r"(\w+)=1\b", got.split("# traces:")[1].split("(")[0])) \
        == set(re.findall(r"(\w+)=\d+", want.split("# traces:")[1].split("(")[0]))
    if not extra:
        assert "1.00 per work iteration" in got
    if extra == ["--no-fused-step"]:
        assert "prefill=1" in got and "decode=1" in got and "legacy two-program split" in got
    if extra == ["--shared-prefix", "16"]:
        assert int(re.search(r"hits=(\d+)", got).group(1)) > 0
    if extra == ["--num-blocks", "3"]:
        assert int(re.search(r"preemptions=(\d+)", got).group(1)) > 0
    assert "attention=plain PyTorch gather" in got


def test_one_shot_mode_runs_as_a_module():
    """``python -m repro_torch.launch.serve --device cpu --smoke`` (one-shot
    mode) exits 0 and prints both engines' lines and the agreement line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                        "--smoke", "--batch", "2", "--prompt-len", "16", "--new-tokens", "4"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[     dense] generated (2, 4)" in r.stdout
    assert "[amber 8:16] generated (2, 4)" in r.stdout
    agree = float(re.search(r"agreement dense vs sparse-prefill: ([\d.]+)", r.stdout).group(1))
    assert 0.0 <= agree <= 1.0


def test_one_shot_mode_moe(capsys):
    """One-shot mode on the Qwen3-30B-A3B smoke config: rc 0, both engines'
    lines and the agreement line."""
    assert main(["--arch", "qwen3_30b_a3b", "--device", "cpu", "--smoke", "--batch", "2",
                 "--prompt-len", "16", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "[     dense] generated (2, 4)" in out and "[amber 8:16] generated (2, 4)" in out
    assert re.search(r"agreement dense vs sparse-prefill: [\d.]+", out)


def test_one_shot_mode_chatglm3(capsys):
    """One-shot mode on the ChatGLM3-6B smoke config (2-D RoPE, q/k/v
    biases): rc 0, both engines' lines and the agreement line."""
    assert main(["--arch", "chatglm3_6b", "--device", "cpu", "--smoke", "--batch", "2",
                 "--prompt-len", "16", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "[     dense] generated (2, 4)" in out and "[amber 8:16] generated (2, 4)" in out
    assert re.search(r"agreement dense vs sparse-prefill: [\d.]+", out)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "recurrentgemma_2b"])
def test_trace_cli_on_the_recurrent_families_matches_jax_cli(capsys, arch):
    """``--smoke --arch rwkv6_7b`` / ``recurrentgemma_2b`` in ``--trace``
    mode: rc 0, served on the slab (``# paged KV: disabled``) in exact
    dyadic chunks, and the JAX CLI's counters: per-request rows, terminal
    states, lifecycle, dispatches and ``# traces:`` (a program captured once
    per chunk length it ran, so ``step_prefill`` more than once).  Then the
    one-shot mode: both engines' lines and the agreement line."""
    flags = ["--arch", arch, "--len-range", "6:30"]
    assert jax_main(TRACE + flags) == 0
    want = capsys.readouterr().out
    assert main(TRACE + flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "# paged KV: disabled (dense per-slot slab)" in got
    rows, lines = _report(got)
    assert rows and rows == _report(want)[0]
    jlines = _report(want)[1]
    for label in ("throughput", "terminal states", "lifecycle", "traces", "dispatches"):
        assert lines[label] == jlines[label], label
    assert int(re.search(r"step_prefill=(\d+)", got).group(1)) > 1
    assert main(["--arch", arch, "--device", "cpu", "--smoke", "--batch", "2",
                 "--prompt-len", "12", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "[     dense] generated (2, 4)" in out and "[amber 8:16] generated (2, 4)" in out
    assert re.search(r"agreement dense vs sparse-prefill: [\d.]+", out)


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2", "--tp", "2"],
                                   ["--tp", "2", "--no-paged"]],
                         ids=["tp", "dp-tp", "tp-no-paged"])
def test_unported_layouts_raise(flags, tmp_path):
    """``--tp 2`` inside an initialised group whose world size is not 2
    raises ``ValueError`` up front, naming the fix.  Outside any group the
    CLI starts the ranks itself (``tests/test_torch_tp.py``)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks but the group has 1"):
            main(TRACE + ["--device", "cpu"] + flags)
    finally:
        dist.destroy_process_group()


def test_cuda_without_a_card_raises(monkeypatch):
    """The default ``--device cuda`` without a GPU raises; the CLI never
    goes on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(TRACE)
