"""PyTorch + CUDA port of the Amber Pruner serving stack for NVIDIA Hopper.

Mirrors the JAX package ``repro`` subpackage by subpackage (``configs``,
``core``, ``kernels``, ``layers``, ``models``, ``serve``) so each module has
an obvious counterpart.  The port imports ``torch`` and numpy only — never
``jax`` and nothing of ``repro``; where it needs a jax-free module of the
JAX package it keeps its own copy.

Entry points (``models.build_model``, ``serve.api.Engine.from_config``) run
on ``cuda`` unless the caller names ``device="cpu"``; without a GPU and
without a named device they raise.  On the card every kernel of the serving
path is a hand-written CUDA C++ kernel for ``sm_90a`` (``kernels/csrc``);
on the CPU each kernel wrapper runs its plain PyTorch version.
"""
