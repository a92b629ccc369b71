"""The port's serve engine at K = 2 ranks over gloo (the reference's
``_multidev_serve_*`` drills, on the port's own process group): each rank
keeps its own quantized arena (its cache draws keyed with its rank) and
the int8 two_phase logit exchange averages the logits every wave.

* ``wire_bytes`` equals the analytic ``wire_per_step`` times the decode
  invocations (ROADMAP C3: the reference's recorder counts double; the
  port holds the analytic count), on both ranks.
* Both ranks commit the same tokens, while their arenas differ (K
  independently quantized caches).
* ``page_corrupt`` scribbles rank 0's arena only: the all-reduced guard
  flag quarantines the slot on both ranks, and every healthy request
  admitted at the wave and slot it had in the clean run gives the clean
  run's tokens bit for bit.  (The exchange's noise is keyed by wave and
  slot row, as the reference's is by step: a request that the fault's
  freed pages admit earlier meets other exchange draws.)
"""

import numpy as np

import _torch_exchange_worker
import _torch_serve_worker
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SPECS = ("", "page_corrupt@3:slot=0")


def test_two_rank_logit_exchange(tmp_path):
    rng = np.random.RandomState(0)
    inputs = {"n_requests": np.int64(7)}
    for r in range(7):
        inputs[f"prompt_{r}"] = rng.randint(0, 512, size=5 + r % 3)
        inputs[f"max_new_{r}"] = np.int64(6 - (r % 3) * 2)
    outs, _ = _torch_exchange_worker.run_group(2, tmp_path, inputs, SPECS,
                                               target=_torch_serve_worker.run_serve)
    for case in outs:
        for o in case:
            assert o["wire_per_step"] > 0
            assert o["wire_bytes"] == o["wire_per_step"] * o["invocations"]
            assert o["free"] == 9
        a, b = case
        assert all(np.array_equal(a[k], b[k]) for k in a if k.startswith(("kind", "tokens")))
        assert a["payload_sum"] != b["payload_sum"]  # two quantizations of one history
    clean, fault = outs[0][0], outs[1][0]
    assert all(str(clean[f"kind_{r}"]) == "ok" for r in range(7))
    kinds = {r: str(fault[f"kind_{r}"]) for r in range(7)}
    assert kinds[0] == "quarantined"
    same = [r for r in range(7) if kinds[r] == "ok"
            and np.array_equal(fault[f"admit_{r}"], clean[f"admit_{r}"])]
    assert len(same) >= 3
    for r in same:
        np.testing.assert_array_equal(fault[f"tokens_{r}"], clean[f"tokens_{r}"])
