"""The device an entry point runs on.

Every entry point of the package takes its device, `cuda` by default, and
stops without a CUDA device unless the caller names `cpu`: nothing falls
back to the CPU on its own. A function raises `NoCudaDevice`; a `main(argv)`
wrapped in `cli_main` turns that into exit code NO_DEVICE_EXIT.
"""

from __future__ import annotations

import functools
import sys

import torch

NO_DEVICE_EXIT = 2  # exit code of a `python -m` entry without its device


class NoCudaDevice(RuntimeError):
    """A CUDA device was asked for and none is visible."""


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`; raises NoCudaDevice for a CUDA device
    where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(f"no CUDA device for device={device}; pass "
                           f"--device cpu to run on the CPU")
    return device


def sync(*devices) -> None:
    """Wait for everything queued on the CUDA devices among `devices`."""
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def cli_main(main):
    """Wrap a `main(argv) -> int` of a `python -m` entry: NO_DEVICE_EXIT
    with a line on stderr where the device is missing, else main's code."""

    @functools.wraps(main)
    def wrapped(argv=None) -> int:
        try:
            return int(main(argv))
        except NoCudaDevice as e:
            print(e, file=sys.stderr, flush=True)
            return NO_DEVICE_EXIT

    return wrapped
