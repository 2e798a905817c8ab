"""Shared helpers of the benchmark's tests: they run on the CPU at small
shapes, with the port's plain versions standing in for its kernels."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]


def run_python(code: str, cwd=None,
               path=(REPO,)) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter with ``path`` (the repo) on its
    path and one torch thread."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(map(str, path)))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd or REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture
def cpu():
    import torch

    torch.set_num_threads(2)
    return torch.device("cpu")
