"""Keep long pytest processes under the kernel's memory-map limit.

Every program XLA compiles for the CPU keeps its code in memory maps of
its own, and JAX's caches hold the programs for the life of the process.
One random-access encode test leaves about 20,000 maps behind, and a
process that passes `vm.max_map_count` (65,530 by default) dies in the
next compile with a segmentation fault: a pytest-xdist worker that is
handed three such tests in a row crashes, whichever tests they are.
After each test this drops JAX's caches once the process holds more
than a quarter of the limit, which frees those maps.

It also has pytest-xdist hand tests to its workers one at a time
(`--maxschedchunk 1`) unless the command line sets a chunk.  By default
`--dist load` deals out runs of neighbouring tests, and the six HEVC
random-access tests of tests/test_inter_qt.py (about 3 minutes each)
sit next to each other, so one worker often gets them all: a serial
chain of about 20 minutes that decides the length of the whole run.
"""

import gc
import sys

import pytest


def _map_limit():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


def _maps_held():
    with open("/proc/self/maps", "rb") as f:
        return sum(1 for _ in f)


_LIMIT = _map_limit()


def pytest_configure(config):
    if getattr(config.option, "maxschedchunk", 0) is None:
        config.option.maxschedchunk = 1


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    yield
    jax = sys.modules.get("jax")
    if jax is None or _LIMIT is None:
        return
    if _maps_held() > _LIMIT // 4:
        jax.clear_caches()
        gc.collect()
