"""The discrete act kernel's staged route in 3xTF32 ``wgmma`` at twin
torsos 1025 and 1813 wide, split off ``tests/test_torch_tf32.py`` (whose
helpers and tolerances it uses, and whose docstring explains the
emulation) to spread the run time over the test workers."""

from __future__ import annotations

import pytest

from tests.test_torch_tf32 import check_staged_wgmma_torso
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("width", [1025, 1813])
def test_staged_wgmma_torso_in_64_deep_chunks(width: int) -> None:
    """``check_staged_wgmma_torso`` at twin torsos 1025 and 1813 wide."""
    check_staged_wgmma_torso(width)
