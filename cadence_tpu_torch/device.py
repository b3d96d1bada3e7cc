"""Which device the port runs on, and what that device and toolchain are.

`resolve_device` is the one rule every entry point follows: None means
the CUDA card, and on a machine without one that raises rather than
running on the CPU; the CPU is used only when the caller names it.

`report` is the probe half: torch, CUDA, the card and its SM version,
`nvcc` and Triton, as one flat dict, so a test or bench line can record
which path it ran on. It never builds or launches anything.
"""
from __future__ import annotations

import shutil
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch version on the CPU")
    return dev


def canonical_device(device) -> torch.device:
    """`device` as the tensors on it name theirs: a CUDA device with its
    index (the current one when it names none), the CPU with none. Two
    names of one card then compare equal, as `torch.device("cuda")` and
    a tensor's `cuda:0` do not. Without CUDA a CUDA name is returned as
    it is (resolve_device raises on it)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def nvcc_path():
    """The CUDA compiler on PATH or under torch's CUDA_HOME, or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = f"{CUDA_HOME}/bin/nvcc"
        if shutil.which(path):
            return path
    return None


def _nvcc_version(path) -> str:
    if path is None:
        return "absent"
    out = subprocess.run([path, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return out[-1] if out else "unknown"


def _triton_version() -> str:
    try:
        import triton
    except ImportError:
        return "absent"
    return triton.__version__


def report() -> dict:
    """torch, CUDA, the card (name, count, SM version), nvcc and Triton."""
    cuda = torch.cuda.is_available()
    out = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvcc": _nvcc_version(nvcc_path()),
        "triton": _triton_version(),
    }
    if cuda:
        major, minor = torch.cuda.get_device_capability(0)
        out["device"] = torch.cuda.get_device_name(0)
        out["sm"] = f"sm_{major}{minor}"
    return out
