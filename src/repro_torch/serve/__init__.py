"""Serving (port of ``repro/serve``): the paged quantized KV-cache
(:mod:`~repro_torch.serve.kv_cache`, writes through kernel 1, reads
through kernel 3), the continuous-batching scheduler
(:mod:`~repro_torch.serve.scheduler`, host logic) and the engine that
binds them to the model (:mod:`~repro_torch.serve.engine`).  Import the
modules directly; the package re-exports nothing (the model stack imports
``kv_cache`` lazily, and an eager import of the engine here would close a
cycle)."""
