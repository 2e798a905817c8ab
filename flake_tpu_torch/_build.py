"""Build helpers: compile a native source into the port's build directory.

Both the host packer (g++) and the CUDA kernels (nvcc) are built at first
use into ``build/flake_tpu_torch/`` beside the package, which git ignores.
A build writes to a temporary name and renames it into place, so processes
that build at the same time never load a half-written library.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = ROOT / "build" / "flake_tpu_torch"


def build(cmd_prefix: list[str], sources: list[pathlib.Path],
          out: pathlib.Path) -> str:
    """Run ``cmd_prefix + sources + -o out`` if ``out`` is missing or older
    than a source. Returns the compiler's output (empty when up to date);
    raises ``RuntimeError`` with it when the build fails."""
    if out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime
                            for s in sources):
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*cmd_prefix, *map(str, sources), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"build failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr
