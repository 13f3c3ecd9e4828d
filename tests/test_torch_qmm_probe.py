"""The variants of ``tools/qmm_loop_probe.py`` still apply to this tree:
every edit's anchor is found exactly once in a copy of ``src``, the split
walk's patch among them (``tools/qmm_split_walk.patch``), so that the
designs kept there as edits can still be built and timed on the card."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

TOOL = Path(__file__).resolve().parents[1] / "tools" / "qmm_loop_probe.py"
_spec = importlib.util.spec_from_file_location("qmm_loop_probe", TOOL)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

# the split walk alone and with the probe's edits of its loop
SPLIT = ["split_walk", "split_walk+no_split_merge", "split_walk+no_merge",
         "split_walk+no_dequant", "split_walk+no_mma"]


@pytest.mark.parametrize("name", probe.DEFAULT + SPLIT)
def test_probe_variant_applies(name, tmp_path):
    src = probe.make_copy(name, tmp_path)
    assert (src / probe.HEADER).is_file()


def test_split_walk_patch_edits_the_kernel_and_its_plan():
    """The patch edits the plan, the kernel header and both formats'
    entry points, and every hunk changes something."""
    edits = probe.patch_edits(probe.SPLIT_PATCH)
    assert {rel for _, _, rel in edits} == {
        probe.PLAN, probe.HEADER, probe.INT8_SOURCE, probe.NF4_SOURCE}
    assert all(old != new for old, new, _ in edits)
