"""One qgenx train step of the VLM family against the reference at K = 1:
``internvl2`` with its 8 stubbed prefix embeds (batch 4 x 20), the int8
two_phase ``de`` step of ``test_torch_moe_step.py`` with the reference's
noise replayed, held at that file's bar (loss rtol 1e-5, ``wire_bytes``
exactly, params rtol 1e-5 / atol 1e-6 on all but 1e-5 of the
coordinates, every coordinate within 1e-2 of the largest weight)."""

import pytest

from test_torch_moe_step import check_step, step_pair
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", ["internvl2"])
def test_int8_two_phase_step_with_replayed_noise(name):
    check_step(step_pair(name))
