"""The port's train step at K = 2 under ``randk`` (``rand_frac`` 0.25)
against the reference on 2 forced host devices: qgenx ``de`` and
``optda``, 3 steps, each worker's support draws replayed.  The helpers,
the reference's subprocess and the tolerances are those of
``tests/test_torch_ef_step_k2.py`` (randk's support is replayed, so no
coordinate can swap).
"""

import pytest

from test_torch_ef_step_k2 import check_case, outputs
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = ("randk-de", "randk-optda")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return outputs(CASES, tmp_path_factory.mktemp("randk_k2"))


@pytest.mark.parametrize("case", CASES)
def test_randk_steps_match_reference_at_two_workers(case, runs):
    ref, outs = runs
    w0, w1 = outs[CASES.index(case)]
    check_case(case, ref, w0, w1)
