"""Worker body of the serve engine's K = 2 test (``test_torch_serve_k2.py``).

Started by ``_torch_exchange_worker.run_group`` (``spawn``, a
``FileStore``, a hard join timeout).  Each rank builds the same reduced
tinyllama-1.1b from one seed, joins the gloo group and runs each case's
engine with the int8 two_phase logit exchange over the group (its cache
draws keyed with its rank), then saves ``out_{case}_{rank}.npz``: each
request's result kind and tokens, the wire bytes, the analytic bytes per
step, the decode invocations, a digest of its arena's K payload and
each request's admission (wave, slot).
"""

import numpy as np
import torch.distributed as dist


def run_serve(rank, world, store_path, in_path, out_dir, cases, backend, device):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig, ProcessGroupComm, make_exchange
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import Request

    torch.set_num_threads(1)
    data = dict(np.load(in_path))
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        model = build(get_config("tinyllama-1.1b").reduced(), seed=0, device=device)
        for p in model.parameters():
            p.requires_grad_(False)
        n = int(data["n_requests"])
        reqs = [(r, data[f"prompt_{r}"].tolist(), int(data[f"max_new_{r}"])) for r in range(n)]
        for i, spec in enumerate(cases):
            ex = make_exchange(ExchangeConfig(
                quant=QuantConfig(num_levels=15, bits=8, bucket_size=512), mode="two_phase"),
                ProcessGroupComm())
            eng = ServeEngine(model.cfg, model, policy="int8", page_size=4, n_slots=3,
                              max_len=32, num_pages=9, seed=0, exchange=ex, guard=True,
                              fault_spec=FaultSpec.parse(spec) if spec else None)
            calls = [0]
            orig = eng._invoke_decode

            def invoke(*a, orig=orig, **kw):
                calls[0] += 1
                return orig(*a, **kw)

            eng._invoke_decode = invoke
            events = []
            eng.run([Request(r, p, m) for r, p, m in reqs], events=events)
            res = eng.results()
            out = {"wire_bytes": np.float64(eng.wire_bytes),
                   "wire_per_step": np.float64(eng.wire_per_step),
                   "invocations": np.int64(calls[0]),
                   "payload_sum": np.int64(eng.cache["seg0_k_payload"].long().abs().sum()),
                   "free": np.int64(eng.allocator.n_free)}
            for kind, rid, slot, step in events:
                if kind == "admit":
                    out[f"admit_{rid}"] = np.array([step, slot], np.int64)
            for rid, rr in res.items():
                out[f"kind_{rid}"] = np.array(rr.kind)
                out[f"tokens_{rid}"] = np.asarray(rr.tokens, np.int64)
            np.savez(f"{out_dir}/out_{i}_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
