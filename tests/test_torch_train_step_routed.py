"""The train step of the routed families (DeepSeek-V3, Jamba) against the
reference on the CPU: ``tests/test_torch_train_step.py``'s one-step case
at their smoke configs, with its helpers and tolerances (``ROUTED_TOL``
on the loss).  These two cases take about half of that file's wall, so
they run in a file of their own, which ``--dist loadfile`` gives its own
worker.
"""
import pytest

from test_torch_train_step import FAMILY_ARCHS, ROUTED_ARCHS, one_step_case


@pytest.mark.parametrize("arch", [a for a in FAMILY_ARCHS
                                  if a in ROUTED_ARCHS])
def test_one_step_matches_reference(arch):
    """One step with ``remat="block"`` on both sides, from one state."""
    one_step_case(arch)
