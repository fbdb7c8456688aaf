"""repro_torch — the SCOPE routing system on PyTorch and CUDA (NVIDIA H100).

A port of ``repro`` (JAX on a TPU).  The package layout mirrors the JAX
one so every module has an obvious counterpart:

  configs/  — the dense estimator configs (``scope-tiny``, ``scope-qwen3-4b``)
  kernels/  — hand-written CUDA kernels for sm_90a, each beside its plain
              PyTorch version, and the device dispatch in ``kernels/ops``
  models/   — the dense GQA + RoPE + qk-norm backbone
  data/     — world simulator, SCOPE data, tokenizer (numpy)
  core/     — fingerprints, retrieval, serialization, estimator, utility
  serving/  — prefill + greedy decode (``serving/sampler``)
  api/      — ``ScopeEngine`` and the routing policies
  io        — the weight bridge from the JAX param pytree / checkpoints

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``
(``device.resolve_device``).  Nothing here imports JAX or ``repro``.
"""
