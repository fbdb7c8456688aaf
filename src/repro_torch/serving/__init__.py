"""Serving substrate: KV-cache sampler, paged KV pool, batched engine,
microbatch scheduler, and the continuous-batching serve runtime.

The routing entry point is ``repro_torch.api.ScopeEngine``; ``scheduler``
turns ragged request streams into fixed-shape bucket microbatches,
``runtime.ServeRuntime`` double-buffers their dispatch so host assembly
overlaps device decode, and ``runtime.SlotRuntime`` chunks decode into
segments and refills drained-at-EOS slots from the queue mid-batch, over a
dense or block-paged (``kv_pool``) KV cache.  ``faults`` injects
deterministic chaos for the fault-tolerance tests.
"""
