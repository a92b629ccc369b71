"""The port's train step at K = 2 against the reference on 2 forced host
devices: cases (c) ``extra_adam`` and (d) QAda of
``_torch_step_k2_reference.CASES``, with the checks and tolerances that
``test_torch_step_k2.py``'s docstring states (that file runs the other
cases; they are split so that the suite's workers share them).
"""

import pytest

import _torch_step_k2_reference as ref_k2
from test_torch_step_k2 import CASES_HERE, check_case
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", [c for c in sorted(ref_k2.CASES) if c not in CASES_HERE])
def test_step_matches_reference_at_two_workers(case, tmp_path):
    check_case(case, tmp_path)
