"""The port's marching examples (07, 11 and 12) end to end on the CPU at
their tiny size, as test_torch_examples.py runs the others."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_examples import MARCHING, check_example  # noqa: E402


@pytest.mark.parametrize("name", MARCHING)
def test_example_runs(name, tmp_path):
    check_example(name, tmp_path)
