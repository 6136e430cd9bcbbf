"""The second half of the CPU legs that chip_smoke.py's phase 8 shares
between chains (chip_smoke.CPU_SAME[3:]: X3D2_BFLY=0 with
keep_pressure=False as X3D2_XDIV_FUSED=0, X3D2_BFLY=0 with X3D2_PIPE3=0 as
X3D2_BFLY=0 with keep_pressure=True, the cylinder's X3D2_MID_SPLIT=1 as
the cylinder), held as
test_torch_shared_legs.py holds the first: each pair stepped on the CPU in
float32 from the same initial state, the states bit-equal.
"""

import pytest

from test_torch_shared_legs import (_clean_switches,  # noqa: F401
                                    check_shared_leg, smoke)

THERE = smoke.CPU_SAME[3:]


@pytest.mark.parametrize("label,shared", THERE, ids=[a for a, _ in THERE])
def test_shared_cpu_leg_is_bit_equal(label, shared):
    check_shared_leg(label, shared)
