"""Device selection for the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Asking for the card where there is none raises; nothing
    falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=64)
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A small read-only constant on ``device``, uploaded once for each
    (values, dtype, device) and shared after that: a train step that built it
    anew would make the host wait for a copy every time. Made outside
    inference mode, so autograd may save it whoever asked first."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def module_command(module: str, device="cuda") -> list:
    """The command line that runs ``module``'s ``main`` in a new Python:
    ``python -u -m module`` on the card (its default); on the CPU a ``-c``
    line that passes the device in. Arguments follow it."""
    import sys

    if torch.device(device).type == "cuda":
        return [sys.executable, "-u", "-m", module]
    return [sys.executable, "-u", "-c",
            f"import sys; from {module} import main; "
            f"main(sys.argv[1:], device={str(device)!r})"]
