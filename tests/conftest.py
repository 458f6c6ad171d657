"""Test configuration.

Tests run on the CPU with 8 virtual devices so multi-device sharding paths
compile and execute without accelerators (SURVEY.md §4: multi-host emulation
via ``xla_force_host_platform_device_count``). x64 is enabled for tight
numeric validation of the kernels; production code paths stay
dtype-polymorphic.

Tests that need a GPU carry the ``gpu`` marker and the ``gpu`` fixture,
which skips them where JAX's default device is not a GPU. On a machine with
a card: ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# parallel LLVM codegen occasionally segfaults on the large solver programs
if "parallel_codegen" not in flags:
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# NOTE: do NOT enable the persistent compilation cache here — XLA:CPU
# executable serialization hard-aborts (C++ CHECK) on some of the large
# solver programs.


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, so
    every test worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; on a machine with one run "
                    "`JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`")
