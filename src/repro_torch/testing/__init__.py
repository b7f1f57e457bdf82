"""``repro_torch.testing`` — the fault-injection harness for the chaos
tests and the chip run (DESIGN.md §7)."""
from repro_torch.testing.faults import (FaultError, FaultPlan,  # noqa: F401
                                        SimulatedCrash, inject)
