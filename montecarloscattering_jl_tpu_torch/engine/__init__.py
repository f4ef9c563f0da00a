"""Run orchestration: setup, the pcut ladder, reductions, outputs."""

from .driver import RunResult, run  # noqa: F401
from .setup import RunSetup, build_setup  # noqa: F401
