"""Environment activation checks and launcher.

Equivalent of ``magmap/io/load_env.py`` (``is_conda_activated :66``,
``is_venv_activated :82``, ``launch_subprocess :93``,
``launch_magmap :120``, ``log_uncaught_exception :143``): verifies a
usable Python environment and launches the port's CLI inside it.
Copy of ``magellanmapper_tpu/io/load_env.py``, except that
:func:`check_accelerator` probes ``torch.cuda`` where the reference probes
JAX's devices, with the same keys; it is only a probe and moves no work.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

_logger = logging.getLogger(__name__)

#: environment name prefix the reference looks for
ENV_NAME = "mag"
_CONDA_ENV_KEY = "CONDA_DEFAULT_ENV"


def is_conda_activated(env_name: str = ENV_NAME) -> bool:
    """True if a conda env whose name starts with ``env_name`` is active
    (reference ``is_conda_activated :66``)."""
    return os.environ.get(_CONDA_ENV_KEY, "").startswith(env_name)


def is_venv_activated() -> bool:
    """True if running inside a venv/virtualenv
    (reference ``is_venv_activated :82``)."""
    return (getattr(sys, "real_prefix", None) is not None
            or sys.base_prefix != sys.prefix
            or bool(os.environ.get("VIRTUAL_ENV")))


def check_accelerator() -> Dict[str, object]:
    """Report the device that a launch would use.

    Returns a dict with ``platform``, ``device_count`` and ``devices``, as
    the reference's JAX probe: ``"gpu"`` (JAX's name for a CUDA device)
    with ``torch.cuda.device_count()`` cards when CUDA is available, else
    ``"cpu"`` with one device; ``"unavailable"`` if torch cannot be
    imported or probed.
    """
    try:
        import torch
        if torch.cuda.is_available():
            count = torch.cuda.device_count()
            return {
                "platform": "gpu", "device_count": count,
                "devices": [torch.cuda.get_device_name(i)
                            for i in range(count)],
            }
        return {"platform": "cpu", "device_count": 1, "devices": ["cpu"]}
    except Exception as exc:  # a broken CUDA runtime raises on the probe
        return {"platform": "unavailable", "device_count": 0,
                "devices": [], "error": str(exc)}


def launch_subprocess(
        args: Sequence[str], working_dir: Optional[str] = None,
        sys_shell: bool = False) -> int:
    """Run a command, optionally through the system shell
    (reference ``launch_subprocess :93``)."""
    if sys_shell:
        return subprocess.call(" ".join(args), shell=True, cwd=working_dir)
    return subprocess.call(list(args), cwd=working_dir)


def build_launch_args(cli_args: Optional[Sequence[str]] = None) -> List[str]:
    """Argv to launch the CLI in the current interpreter."""
    return [sys.executable, "-u", "-m", "magellanmapper_torch.io.cli",
            *(cli_args or [])]


def launch_magmap(cli_args: Optional[Sequence[str]] = None) -> int:
    """Launch the CLI in the current environment
    (reference ``launch_magmap :120``)."""
    accel = check_accelerator()
    _logger.info("launching on platform %s (%d device(s))",
                 accel["platform"], accel["device_count"])
    return launch_subprocess(build_launch_args(cli_args))


def log_uncaught_exception(exc_type, exc, trace) -> None:
    """Route uncaught exceptions through logging
    (reference ``log_uncaught_exception :143``)."""
    _logger.critical(
        "Unhandled exception", exc_info=(exc_type, exc, trace))


def main() -> int:
    sys.excepthook = log_uncaught_exception
    return launch_magmap(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
