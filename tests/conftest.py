"""Test configuration: run everything on CPU with 8 virtual devices so the
multi-device sharding paths are exercised without accelerator hardware, and
with float64 enabled (matching the reference's gradient-exactness
tolerances). ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`` runs
the tests that need the card on a GPU machine."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _bound_compiled_program_accumulation():
    """Clear JAX's compiled-executable caches after every test module.

    Without this, the full suite crashes DETERMINISTICALLY (SIGABRT or
    SIGSEGV — the mode varies, the location doesn't) inside XLA:CPU's
    ``backend_compile_and_load`` around test ~177 of ~197
    (tests/test_sharding.py), after ~180 accumulated compilations with 8
    virtual devices. Bisection (2026-08-20, round 4) showed it is an
    ACCUMULATION THRESHOLD, not a file interaction: the full file set
    crashes, but dropping EITHER the first or the second half of the
    preceding files makes the identical remainder pass — no small
    reproducer exists, and every file passes in isolation. The varying
    fatal signal under one deterministic trigger points at allocator/JIT
    code-arena exhaustion or corruption inside XLA:CPU, not at any test's
    semantics. Bounding the number of live compiled executables to one
    module's worth sidesteps it at the cost of cross-module recompiles.
    """
    yield
    jax.clear_caches()


@pytest.hookimpl(trylast=True)
def pytest_sessionfinish(session, exitstatus):
    """Hard-exit after the terminal summary: the XLA:CPU executable-
    accumulation crash (see _bound_compiled_program_accumulation above)
    moved from mid-suite (round 4, ~test 177) to INTERPRETER EXIT once the
    per-module cache clearing bounded live executables — with 216 tests the
    suite now completes 100% of its dots and then segfaults in XLA's
    teardown, losing the summary line and corrupting the exit code.
    ``os._exit`` preserves pytest's real exit status and skips the doomed
    C++ destructor pass. (trylast => the terminal reporter has already
    printed its summary.)"""
    import os as _os
    import sys as _sys

    _sys.stdout.flush()
    _sys.stderr.flush()
    _os._exit(int(exitstatus))
