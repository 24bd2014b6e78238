"""Which device a measurement ran on, and refusal to measure without a GPU.

Every number a bench or profiler prints names its device: JAX's platform,
device kind and device count, plus the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs slower
under load). nvidia-smi runs in a child process that never imports JAX, so
no second process opens the card.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def card() -> str:
    """``name, power.limit`` of the first card, from nvidia-smi.

    Raises RuntimeError when nvidia-smi gives no such line: a number
    without its card and power limit cannot be compared with another.
    """
    try:
        out = subprocess.run(NVIDIA_SMI, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    lines = out.stdout.strip().splitlines()
    line = lines[0].strip() if lines else ""
    fields = [f.strip() for f in line.split(",")]
    if out.returncode or len(fields) != 2 or not fields[1].endswith("W"):
        raise RuntimeError(f"nvidia-smi gave no 'name, power.limit' line "
                           f"(rc {out.returncode}): {line!r} "
                           f"{out.stderr.strip()!r}")
    return line


def require_gpu(what: str) -> dict:
    """The device record for a measurement; exits non-zero without a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"{what} measures the GPU, but JAX found no GPU "
                         f"(platform {devs[0].platform!r}); refusing to run")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card()}
