"""Settings of the benchmark's own tests (``python -m pytest
bench_port/tests``): the ``chip`` marker, for tests that need a CUDA card
and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one); run on the "
        "card with python -m pytest bench_port/tests -m chip")
